"""A mutation-fuzz campaign over the port's DICOM reader under AddressSanitizer
and UndefinedBehaviorSanitizer.

Counterpart of the JAX package's ``tools/fuzz_dicom.py``, on the port's own
reader (``csrc/dicom.cc``).  It compiles the reader with
``-fsanitize=address,undefined -fno-sanitize-recover=all`` into the
git-ignored build directory (``csrc/build/``), writes a seed file for every
container and codec the reader decodes with the port's own encoders
(``tools/dicom_encoders.py``: explicit and implicit VR, deflated, RLE, JPEG
Lossless, JPEG-LS, JPEG sequential DCT, JPEG 2000 codestreams of four
kinds and a JP2 file), and drives mutated inputs (random bytes, a
truncation, bytes in the tail, a spliced window) through one persistent
sanitized process.  A sanitizer fault or a hang ends that process: the
input and the sanitizer's report are kept under ``--out`` and a new process
takes the next input.  The exit code is the number of faults (capped at
255), 0 for a clean campaign.

Where the compiler cannot build or run a sanitized binary the tool exits
non-zero and says so; it never fuzzes an unsanitized build instead.

    python -m montecarlo_gated_mil_tpu_torch.tools.fuzz_dicom [--trials-per-seed 1000] \\
        [--seed 0] [--out tool_out/fuzz_dicom]
"""

from __future__ import annotations

import hashlib
import os
import select
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from montecarlo_gated_mil_tpu_torch.data.dicom_native import BUILD_DIR, SOURCE
from montecarlo_gated_mil_tpu_torch.tools import _common, dicom_encoders as enc

SANITIZER_FLAGS = ("-O1", "-g", "-fsanitize=address,undefined", "-fno-sanitize-recover=all")
SANITIZER_ENV = {"ASAN_OPTIONS": "abort_on_error=1:detect_leaks=1",
                 "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1"}
HANG_SECONDS = 20.0  # an input the reader has not answered by then is kept as a hang
DEFAULT_OUT = os.path.join("tool_out", "fuzz_dicom")
# One input path a line on stdin; "rc <code>" a line back.
HARNESS = r"""
#include "dicom.cc"
#include <cstdio>
#include <cstring>
int main() {
  char line[4096];
  while (fgets(line, sizeof(line), stdin)) {
    line[strcspn(line, "\n")] = 0;
    if (!line[0]) continue;
    DicomResult res;
    int rc = mcgmil_dicom_read(line, &res);
    if (rc == 0) mcgmil_dicom_free(&res);
    printf("rc %d\n", rc);
    fflush(stdout);
  }
  return 0;
}
"""


class SanitizerUnavailable(RuntimeError):
    """The compiler cannot build, or the host cannot run, a sanitized reader."""


def build_fuzzer() -> Path:
    """The sanitized reader and its harness, built once per source and flags
    into ``csrc/build/``.  Raises :class:`SanitizerUnavailable` with the
    compiler's message when the build fails."""
    h = hashlib.sha256(" ".join(SANITIZER_FLAGS).encode() + HARNESS.encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"dicom_fuzz-{h.hexdigest()[:16]}"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    harness = BUILD_DIR / f"dicom_fuzz_harness.{os.getpid()}.cc"
    harness.write_text(HARNESS)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *SANITIZER_FLAGS, "-I", str(SOURCE.parent), "-o", str(tmp), str(harness), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except FileNotFoundError as e:
        raise SanitizerUnavailable(f"{cmd[0]} not found") from e
    finally:
        harness.unlink(missing_ok=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise SanitizerUnavailable(f"{' '.join(cmd)} failed:\n{proc.stderr[-3000:]}")
    os.replace(tmp, out)
    return out


def make_seeds(directory: Path, rng: np.random.Generator) -> tuple[list[Path], list[str]]:
    """A 24x20 12-bit image in every container and codec the reader
    decodes: the seed files, and what could not be written (JPEG 2000 needs
    Pillow's OpenJPEG codec)."""
    rows, cols, bits = 24, 20, 12
    px = rng.integers(0, 2**bits, size=(rows, cols), dtype=np.uint16)
    seeds, missing = [], []

    def emit(name, writer):
        path = directory / f"{name}.dcm"
        writer(path)
        seeds.append(path)

    def encapsulated(uid, frame):
        return lambda p: enc.write_encapsulated(p, rows, cols, bits, uid, frame)

    emit("explicit", lambda p: enc.write_dicom(p, rows, cols, bits, px))
    emit("implicit", lambda p: enc.write_dicom(p, rows, cols, bits, px, explicit=False))
    emit("deflated", lambda p: enc.write_deflated(p, rows, cols, bits, px))
    emit("rle", encapsulated(b"1.2.840.10008.1.2.5", enc.rle_frame(px)))
    emit("jpeg_lossless", encapsulated(b"1.2.840.10008.1.2.4.70",
                                       enc.jpeg_lossless_frame(px, bits, restart=7)))
    emit("jpeg_ls", encapsulated(b"1.2.840.10008.1.2.4.80", enc.jls_frame(px, bits)))
    emit("jpeg_dct", encapsulated(b"1.2.840.10008.1.2.4.51",
                                  enc.dct_frame(px, bits, restart=3)[0]))
    from PIL import features

    if not features.check_codec("jpg_2000"):
        missing.append("JPEG 2000 (Pillow has no OpenJPEG codec)")
        return seeds, missing
    variants = {
        "j2k_basic": dict(num_resolutions=4),
        "j2k_geometry": dict(codeblock_size=(16, 16), precinct_size=(64, 64),
                             quality_mode="rates", quality_layers=[8, 0]),
        "j2k_tiled": dict(tile_size=(16, 16), num_resolutions=2),
        "j2k_pcrl": dict(progression="PCRL", num_resolutions=3),
        "j2k_jp2": dict(no_jp2=False),
    }
    for name, kw in variants.items():
        emit(name, encapsulated(b"1.2.840.10008.1.2.4.90", enc.j2k_codestream(px, **kw)))
    return seeds, missing


def mutate(data: bytes, trial: int, rng: np.random.Generator) -> bytes:
    """The JAX tool's four mutations, in turn: 1-4 random bytes anywhere, a
    truncation, 1-8 bytes in the second half (the entropy-coded data), a
    window copied from elsewhere in the file."""
    data = bytearray(data)
    kind = trial % 4
    if kind == 0:
        for _ in range(rng.integers(1, 5)):
            data[rng.integers(0, len(data))] = rng.integers(0, 256)
    elif kind == 1:
        data = data[: rng.integers(1, len(data))]
    elif kind == 2:
        for _ in range(rng.integers(1, 9)):
            data[rng.integers(len(data) // 2, len(data))] = rng.integers(0, 256)
    else:
        n = len(data)
        w = int(rng.integers(2, max(3, n // 8)))
        src, dst = int(rng.integers(0, n - w)), int(rng.integers(0, n - w))
        data[dst:dst + w] = data[src:src + w]
    return bytes(data)


class _Reader:
    """The sanitized reader as a persistent process; its reports go to a
    log file of its own."""

    def __init__(self, binary: Path, log: Path):
        self.log_path = log
        self.log = open(log, "w")
        self.proc = subprocess.Popen([str(binary)], stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self.log, text=True,
                                     env={**os.environ, **SANITIZER_ENV})

    def read(self, path: Path) -> str:
        """The reader's answer (``"rc N"``), ``"fault"`` when it died, or
        ``"hang"`` when it gave none within HANG_SECONDS."""
        try:
            self.proc.stdin.write(f"{path}\n")
            self.proc.stdin.flush()
        except BrokenPipeError:
            return "fault"
        ready, _, _ = select.select([self.proc.stdout], [], [], HANG_SECONDS)
        if not ready:
            return "hang"
        return self.proc.stdout.readline().strip() or "fault"

    def close(self) -> int:
        """Ends the process; its exit code (the leak check runs at exit)."""
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                self.proc.wait(timeout=60)
            except (BrokenPipeError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()
        self.log.close()
        return self.proc.returncode


def main(argv=None, *, device="cpu") -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("--trials-per-seed", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0, help="the mutations' numpy seed")
    ap.add_argument("--out", default=DEFAULT_OUT, help="seeds, kept inputs and reports")
    args = ap.parse_args(argv)
    _common.start(device)
    out = Path(args.out)
    (out / "seeds").mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        binary = build_fuzzer()
    except SanitizerUnavailable as e:
        raise SystemExit(f"fuzz_dicom: cannot build the reader with sanitizers, so nothing is "
                         f"fuzzed (an unsanitized build would not show faults): {e}") from e
    print(f"[fuzz] sanitized reader {binary.name} ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(args.seed)
    seeds, missing = make_seeds(out / "seeds", rng)
    for what in missing:
        print(f"[fuzz] no seed for {what}", flush=True)
    n_logs = 0

    def start():
        nonlocal n_logs
        n_logs += 1
        return _Reader(binary, out / f"sanitizer_{n_logs}.log")

    reader = start()
    for path in seeds:  # every seed parses as it is, or the campaign means nothing
        answer = reader.read(path)
        if answer != "rc 0":
            reader.close()
            report = reader.log_path.read_text()[-3000:]
            raise SystemExit(f"fuzz_dicom: the sanitized reader did not read the unmutated seed "
                             f"{path.name} ({answer!r}); its log:\n{report}")
    print(f"[fuzz] {len(seeds)} seeds read cleanly; {args.trials_per_seed} trials each",
          flush=True)
    target = out / "input.dcm"
    faults, total, refused = [], 0, 0
    for path in seeds:
        seed_bytes = path.read_bytes()
        for trial in range(args.trials_per_seed):
            target.write_bytes(mutate(seed_bytes, trial, rng))
            answer = reader.read(target)
            total += 1
            if answer in ("fault", "hang"):
                reader.close()
                keep = out / f"{answer}_{path.stem}_{trial}.dcm"
                os.replace(target, keep)
                faults.append(dict(seed=path.stem, trial=trial, input=str(keep), kind=answer,
                                   log=str(reader.log_path)))
                print(f"[fuzz] {answer.upper()} on {path.stem} trial {trial}: input {keep}, "
                      f"report {reader.log_path}", flush=True)
                reader = start()
            elif answer != "rc 0":
                refused += 1
        print(f"[fuzz] {path.stem}: done ({total} trials so far)", flush=True)
    code = reader.close()
    log = reader.log_path.read_text()
    if code != 0:
        faults.append(dict(seed=None, trial=None, input=None, kind=f"exit {code}",
                           log=str(reader.log_path)))
        print(f"[fuzz] FAULT: the reader's last process exited {code} (a leak, or a sanitizer "
              f"that could not run at exit); its log:\n{log[-3000:]}", flush=True)
    target.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    print(f"[fuzz] {total} trials over {len(seeds)} seeds in {seconds:.1f} s: {refused} refused "
          f"with an error, {len(faults)} faults", flush=True)
    return dict(trials=total, seeds=[p.stem for p in seeds], missing=missing, refused=refused,
                faults=faults, seconds=seconds)


if __name__ == "__main__":
    sys.exit(min(len(main()["faults"]), 255))
