"""The process-wide TF32 flags, cleared for a window and restored after.

cuDNN runs float32 convolutions in TF32 by PyTorch's default, and the matrix
products may be set to; a float32 model's exact paths (``models/resnet.py``'s
exact-float windows, the plain head of ``ops/gated_attention.py``) clear the
flags around their work through :func:`tf32_off`, which both layers share.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# The process-wide TF32 flags that the exact-float windows clear:
# cuDNN's, and the matrix products' (gradients and the plain head clear
# that one).
_TF32_FLAGS = {
    "cudnn": torch.backends.cudnn,
    "matmul": torch.backends.cuda.matmul,
}
# Requests run their device work in concurrent threads (``MCDOPredictor(
# max_inflight=k)``), so the windows of several threads overlap.  One lock
# and, per flag, the number of windows open and the value found by the
# first: the first to open clears the flag, the last to close restores it,
# and no thread restores it while another's window is open.
_tf32_lock = threading.Lock()
_tf32_open = {name: 0 for name in _TF32_FLAGS}
_tf32_found: dict[str, bool] = {}


@contextlib.contextmanager
def tf32_off(*names: str):
    """The named TF32 flags are off while any thread is inside a window
    that names them, and back to what the first window found once the last
    one has closed."""
    with _tf32_lock:
        for name in names:
            if _tf32_open[name] == 0:
                _tf32_found[name] = _TF32_FLAGS[name].allow_tf32
                _TF32_FLAGS[name].allow_tf32 = False
            _tf32_open[name] += 1
    try:
        yield
    finally:
        with _tf32_lock:
            for name in names:
                _tf32_open[name] -= 1
                if _tf32_open[name] == 0:
                    _TF32_FLAGS[name].allow_tf32 = _tf32_found.pop(name)
