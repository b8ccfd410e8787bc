"""Measurement tools of the port, the counterparts of the JAX package's
``tools/``: each is ``python -m montecarlo_gated_mil_tpu_torch.tools.<name>``
and ``main(argv=None, *, device="cuda")``, prints the card's line first and
runs with the main path's settings (``_common.main_path_settings``).
``fuzz_dicom`` is host code (``device="cpu"``); ``dicom_encoders`` holds the
DICOM writers its seeds and the tests use."""
