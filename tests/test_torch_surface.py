"""The port covers the JAX package's public surface (read from source).

Both packages are parsed with ``ast``; nothing of JAX is imported.  Every
public function and class of a module of ``montecarlo_gated_mil_tpu/``
must be defined or imported at the top of the port's module of the same
path, and every public method (and ``__init__``) of such a class must be
there too; every parameter of a same-named function or method must be a
parameter of the port's.  The only exceptions are ``UNPORTED``, and each of
its names must appear in ROADMAP.md's queue 1, which records why it is
never ported or under which name the port has it.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "montecarlo_gated_mil_tpu"
PORT_PKG = ROOT / "montecarlo_gated_mil_tpu_torch"

# ROADMAP.md queue 1's "Never to be ported", "never" and "under another
# name" entries, by the JAX module they are in.  A name is a public function
# or class, ``Class.method``, or ``function(parameter)``.
UNPORTED = {
    # core/rng.py's key objects: the port derives integer seeds.
    "core/rng.py": ["root_key", "named_key", "epoch_key", "mc_keys", "key_iter"],
    # models/port.py: the port's modules load a torchvision state_dict as it
    # is; weights.py is the inverse.
    "models/port.py": ["load_state_dict", "port_backbone", "load_backbone_params",
                       "port_multihead_gamil", "port_singlehead_gamil"],
    # ResNetFeatures(space_to_depth=True); make_backbone's named mesh axis.
    "models/resnet.py": ["SpaceToDepthStem", "make_backbone(bn_axis_name)"],
    # Flax's module setup and the L property: the port's nn.Module sets L in
    # __init__ (an attribute, not a method).
    "models/gamil.py": ["MultiHeadGatedAttentionMIL.setup", "MultiHeadGatedAttentionMIL.L",
                        "GatedAttentionMIL.setup", "GatedAttentionMIL.L"],
    # mc_gated_attention_fused is mc_gated_attention; explicit PRNG keys.
    "ops/gated_attention.py": ["mc_gated_attention_fused", "mc_head_reference(key)"],
    # axis/keepdims are dim/keepdim, as in torch.
    "ops/masked.py": ["masked_softmax(axis)", "masked_mean(axis)", "masked_mean(keepdims)",
                      "masked_var(axis)", "masked_var(keepdims)"],
    # The DMA-alignment helpers; gather_tiles_dma is gather_selected, whose
    # sel_starts is starts and whose grid and image_padded serve the DMA path.
    "ops/patching.py": ["gather_remainders", "gather_tiles_dma", "pad_for_dma_gather",
                        "gather_selected(sel_starts)", "gather_selected(grid)",
                        "gather_selected(image_padded)"],
    "ops/quantized.py": ["quantize_backbone_static(params)", "quantized_embed_static(qparams)"],
    "data/pipeline.py": ["image_to_bag(key)"],
    "evaluation/dp_eval.py": ["mc_test_dp(params)", "mc_test_dp(key)"],
    "mcdo/ensemble.py": ["ensemble_mc_inference(stacked_params)", "ensemble_mc_inference(key)",
                         "ensemble_mc_inference_sharded(stacked_params)",
                         "ensemble_mc_inference_sharded(key)", "load_fold_ensemble(template)",
                         "load_fold_ensemble(ckpt)"],
    "mcdo/sampling.py": ["mc_head(variables)", "mc_head(key)", "mc_inference(variables)",
                         "mc_inference(key)", "mc_inference_serial(variables)",
                         "mc_inference_serial(key)", "mc_inference_single_head(variables)",
                         "mc_inference_single_head(key)"],
    "models/causal.py": ["causal_counterfactual_dropout(variables)",
                         "causal_counterfactual_dropout(key)"],
    "parallel/dp.py": ["make_dp_train_step(donate)", "pad_group_to_batch(keys)"],
    "parallel/instance.py": ["sharded_embed(params)", "sharded_embed_grad(feat_params)",
                             "mc_inference_sharded(key)", "sharded_mc_gated_attention(key)"],
    # A NamedSharding's rank, a pytree of arrays: the port splits a tensor.
    "parallel/mesh.py": ["data_sharded(rank)", "shard_batch(tree)"],
    "runners.py": ["init_params", "initial_params"],
    # The tunnel machinery and the AOT cache.
    "serve.py": ["MCDOPredictor.__init__(params)", "MCDOPredictor.__init__(pipelined_uploads)",
                 "MCDOPredictor.from_config(params)", "MCDOPredictor.aot_warmup",
                 "MCDOPredictor.absorb_first_fetch"],
    "server.py": ["run_server(aot_cache)"],
    "train/loops.py": ["validate(params)", "mc_validate(params)", "test(params)",
                       "mc_test(params)", "mc_test(key)", "ensemble_mc_test(stacked_params)",
                       "ensemble_mc_test(key)"],
    # optax's TrainState.create is TrainState(model, optimizer, scheduler).
    "train/state.py": ["make_train_step(donate)", "TrainState.create",
                       "Checkpointer.restore(state_like)",
                       "Checkpointer.restore_params(params_like)"],
    # The lax.scan chain takes the bag's arrays and a key; the port's chain
    # takes the Bag and a seed.  xla_trace: the port traces with torch.profiler.
    "utils/profiling.py": ["train_step_chain(patches)", "train_step_chain(mask)",
                           "train_step_chain(label)", "train_step_chain(tile_indices)",
                           "train_step_chain(key)", "xla_trace"],
}


def _surface(path: Path) -> tuple[dict, set]:
    """A module's public surface: ``{name: FunctionDef | ClassDef}`` with
    ``Class.method`` entries for its methods, and every name bound at the
    top level (definitions, assignments, imports)."""
    tree = ast.parse(path.read_text())
    defs, bound = {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defs[node.name] = node
            bound.add(node.name)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        defs[f"{node.name}.{sub.name}"] = sub
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            bound |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound |= {a.asname or a.name.split(".")[0] for a in node.names}
    return defs, bound


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _public(name: str) -> bool:
    parts = name.split(".")
    return not parts[0].startswith("_") and (
        len(parts) == 1 or not parts[1].startswith("_") or parts[1] == "__init__")


def _gaps() -> list[str]:
    """Every public name and parameter of the JAX package the port lacks,
    as ``module: name`` (see ``UNPORTED`` for the forms)."""
    gaps = []
    for jpath in sorted(JAX_PKG.rglob("*.py")):
        rel = jpath.relative_to(JAX_PKG).as_posix()
        jdefs, _ = _surface(jpath)
        ppath = PORT_PKG / rel
        pdefs, pbound = _surface(ppath) if ppath.exists() else ({}, set())
        for name, node in jdefs.items():
            if not _public(name):
                continue
            present = name in pdefs if "." in name else name in pbound
            if not present:
                gaps.append(f"{rel}: {name}")
                continue
            if isinstance(node, ast.ClassDef) or not isinstance(
                    pdefs.get(name), (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            theirs = _params(pdefs[name])
            gaps += [f"{rel}: {name}({p})" for p in _params(node) if p not in theirs]
    return gaps


def _unported() -> set[str]:
    return {f"{mod}: {name}" for mod, names in UNPORTED.items() for name in names}


def test_port_has_every_public_name_and_parameter():
    """Nothing of the JAX package's surface is missing from the port but
    what ``UNPORTED`` lists."""
    missing = [g for g in _gaps() if g not in _unported()]
    assert missing == []


def test_every_exception_is_still_a_gap():
    """Each ``UNPORTED`` entry names something the port really lacks, so
    the list cannot hide a name once the port has it."""
    assert sorted(_unported() - set(_gaps())) == []


@pytest.mark.parametrize("mod", sorted(UNPORTED))
def test_exceptions_are_recorded_in_the_roadmap(mod):
    """Every excepted name is written in ROADMAP.md's queue 1, where the
    reason it is never ported, or the port's name for it, stands; the head
    switch and the loader's fixed order are not among them."""
    text = (ROOT / "ROADMAP.md").read_text()
    queue1 = text[text.index("### 1. Modules to port"):text.index("### 2. TPU kernels to port")]
    spans = " ".join(re.findall(r"`([^`]+)`", queue1))
    for entry in UNPORTED[mod]:
        name = entry.split("(")[-1].rstrip(")") if "(" in entry else entry.split(".")[-1]
        word = "*_like" if name.endswith("_like") else name
        assert re.search(rf"(?<![\w*]){re.escape(word)}(?!\w)", spans), (mod, entry)
        assert name not in ("use_pallas", "sample_order")
