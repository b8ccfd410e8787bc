"""Every gradient of a float32 model runs with TF32 off, whatever the
process's flags (``models/resnet.py::exact_float_grads``).

cuDNN runs float32 convolutions in TF32 by PyTorch's default, and autograd
runs the backward convolutions after the model's forward has closed its own
exact-convolution context.  So each training path takes its gradient inside
``exact_float_grads``.  On the CPU no convolution runs in TF32, so these
tests read the flags themselves: a hook on every convolution weight of the
embed, which runs while the backward runs, records both TF32 flags.  Each
path runs with both flags set to ``True`` beforehand and must find them
``True`` again afterwards.  Sizes: 64x64 patches, 10 instances (8 valid).

The two context managers (``exact_float_grads`` and the forward's
``_exact_float_convs``) share one count of open windows per flag, so
that concurrent requests (``MCDOPredictor(max_inflight=k)``) and nested
windows never restore a flag while another window is open.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from montecarlo_gated_mil_tpu_torch.core.bag import Bag
from montecarlo_gated_mil_tpu_torch.models.gamil import (
    GatedAttentionMIL,
    MultiHeadGatedAttentionMIL,
)
from montecarlo_gated_mil_tpu_torch.models.resnet import _exact_float_convs, exact_float_grads
from montecarlo_gated_mil_tpu_torch.parallel import make_dp_train_step, make_mesh
from montecarlo_gated_mil_tpu_torch.parallel.dp import pad_group_to_batch
from montecarlo_gated_mil_tpu_torch.train import loops
from montecarlo_gated_mil_tpu_torch.train.criteria import cross_entropy
from montecarlo_gated_mil_tpu_torch.train.state import (
    TrainState,
    make_train_step,
    make_train_step_sharded,
)

CPU = torch.device("cpu")
N, HW = 10, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags() -> tuple[bool, bool]:
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@contextlib.contextmanager
def _tf32_on():
    """Both TF32 flags on around a call, as a process might have them, and
    back to what they were after the check that the call left them on."""
    old = _flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
        assert _flags() == (True, True), "the call did not restore the TF32 flags"
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _watch(model) -> list[tuple[bool, bool]]:
    """The TF32 flags each convolution weight's gradient hook saw, in
    order."""
    seen = []
    convs = [m for m in model.feature_extractor.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 20  # r18: the stem, 16 block convs, 3 downsamples
    for conv in convs:
        conv.weight.register_hook(lambda g: seen.append(_flags()))
    return seen


def _bag(seed: int, label: int) -> Bag:
    g = np.random.default_rng(seed)
    mask = np.arange(N) < 8
    x = g.standard_normal((N, HW, HW, 3)).astype(np.float32) * mask[:, None, None, None]
    return Bag(torch.from_numpy(x), torch.from_numpy(mask), torch.tensor(label), torch.arange(N))


def _model():
    torch.manual_seed(0)
    return MultiHeadGatedAttentionMIL(feature_dropout=0.1, attention_dropout=0.1)


def _assert_exact_throughout(seen, calls: int) -> None:
    assert len(seen) >= 20 * calls, "the hooks did not run in the backward"
    assert set(seen) == {(False, False)}, f"a gradient ran with TF32 flags {set(seen)}"


def test_helper_restores_the_flags_and_passes_bf16_through():
    with _tf32_on():
        with exact_float_grads(torch.float64):
            assert _flags() == (False, False)
        with exact_float_grads(torch.bfloat16):
            assert _flags() == (True, True)
        with pytest.raises(RuntimeError), exact_float_grads(torch.float32):
            assert _flags() == (False, False)
            raise RuntimeError
        assert _flags() == (True, True)


def test_make_train_step_backward_runs_exact():
    model = _model()
    seen = _watch(model)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    step = make_train_step(model, cross_entropy, opt, 2)
    state = TrainState(model, opt)
    with _tf32_on():
        for i in range(2):
            state, out = step(state, _bag(i, i % 2), 7 + i, i == 1)
    assert np.isfinite(float(out["loss"])) and state.step == 1
    _assert_exact_throughout(seen, 2)


def test_train_epoch_plain_backward_runs_exact():
    torch.manual_seed(1)
    model = GatedAttentionMIL()
    seen = _watch(model)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    bags = [(_bag(i, i % 2), None) for i in range(2)]
    with _tf32_on():
        state = loops.train_epoch_plain(model, TrainState(model, opt), bags, opt, epoch=1, key=3)
    assert state.step == 2
    _assert_exact_throughout(seen, 2)


def test_dp_train_step_backward_runs_exact():
    model = _model()
    seen = _watch(model)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    mesh = make_mesh(data=2, inst=1, devices=[CPU, CPU])
    step, _ = make_dp_train_step(model, cross_entropy, opt, mesh)
    shards, seeds, _ = pad_group_to_batch(mesh, [_bag(0, 1), _bag(1, 0)], [4, 5])
    with _tf32_on():
        state, out = step(TrainState(model, opt), shards, seeds, [1.0, 1.0], True)
    assert float(out["count"]) == 2.0 and state.step == 1
    _assert_exact_throughout(seen, 2)


def test_sharded_train_step_backward_runs_exact():
    """The step's backward, with the shards' graphs replayed inside it
    (``parallel/instance.py::sharded_embed_grad``), runs exact."""
    model = _model()
    seen = _watch(model)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    mesh = make_mesh(data=1, inst=2, devices=[CPU, CPU])
    step = make_train_step_sharded(model, cross_entropy, opt, 1, mesh)
    with _tf32_on():
        state, out = step(TrainState(model, opt), _bag(2, 1), 9, True)
    assert np.isfinite(float(out["loss"])) and state.step == 1
    _assert_exact_throughout(seen, 1)


WINDOWS = {"convs": _exact_float_convs, "grads": exact_float_grads}


@pytest.mark.parametrize("first,second", [("convs", "convs"), ("grads", "grads"),
                                          ("convs", "grads"), ("grads", "convs")])
def test_overlapping_windows_of_two_threads(first, second):
    """A opens, B opens, A closes, B reads the flags, B closes; ordered by
    events.  Inside B's window after A has left, B's flags are still off;
    after both have left, the flags read what they read before."""
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen, errors = {}, []

    def run(fn):
        def body():
            try:
                fn()
            except BaseException as e:  # reported by the test thread
                errors.append(e)
                a_in.set(), b_in.set(), a_out.set()
        return threading.Thread(target=body)

    def a():
        with WINDOWS[first](torch.float32):
            a_in.set()
            assert b_in.wait(10)
        a_out.set()

    def b():
        assert a_in.wait(10)
        with WINDOWS[second](torch.float32):
            b_in.set()
            assert a_out.wait(10)
            seen["inside"] = _flags()

    old = _flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        threads = [run(a), run(b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        seen["after"] = _flags()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
    assert not errors, errors
    assert seen["inside"] == (False, second == "convs"), seen
    assert seen["after"] == (True, True), seen


@pytest.mark.parametrize("start", [(True, True), (False, False), (True, False), (False, True)])
def test_nested_and_mixed_windows(start):
    """Windows nested in one thread, in both orders, and one closed by an
    exception: the inner one's exit leaves the outer one's flags off, and
    the outermost restores the flags the process had."""
    old = _flags()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = start
    try:
        with exact_float_grads(torch.float32):
            with _exact_float_convs(torch.float32):
                assert _flags() == (False, False)
            assert _flags() == (False, False)
        assert _flags() == start
        with _exact_float_convs(torch.float64):
            assert _flags() == (False, start[1])
            with exact_float_grads(torch.float32):
                assert _flags() == (False, False)
                with _exact_float_convs(torch.float32):
                    assert _flags() == (False, False)
            assert _flags() == (False, start[1])
            with pytest.raises(RuntimeError), exact_float_grads(torch.float64):
                raise RuntimeError
            assert _flags() == (False, start[1])
            with exact_float_grads(torch.bfloat16), _exact_float_convs(torch.int8):
                assert _flags() == (False, start[1])
        assert _flags() == start
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
