"""The uncertainty acceptance's five criteria per training seed, in both packages.

    JAX_PLATFORMS=cpu python tests/uncertainty_seeds.py --packages jax --seeds 0,1,2
    python tests/uncertainty_seeds.py --packages port --seeds 0,1,2 [--device cpu]

For each seed it trains the JAX package's harness (``tests/test_uncertainty.py``:
init and dropout key ``jax.random.key(seed)``, on the CPU) and the port's
(``evaluation/uncertainty.py``: ``train_toy_model(seed=seed)``, on
``--device``, the card unless told otherwise), then prints one line per
package and seed: the last-epoch fit accuracy, the ambiguous/clear MC std
and entropy ratios, the lesion attention mass over the uniform share and the
lesion/background attention std ratio, each beside its threshold and whether
it passes (``uncertainty.criteria``).  The acceptance itself trains seed 0
only; this shows how each criterion depends on the trajectory.  About a
minute a seed and package on a CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def jax_ratios(seed: int) -> tuple[float, ...]:
    import jax
    import jax.numpy as jnp
    import optax

    from montecarlo_gated_mil_tpu.models import MultiHeadGatedAttentionMIL
    from montecarlo_gated_mil_tpu.train.criteria import cross_entropy
    from montecarlo_gated_mil_tpu.train.state import TrainState, make_train_step
    from tests import test_uncertainty as h

    model = MultiHeadGatedAttentionMIL(backbone="r18", feature_dropout=0.25,
                                       attention_dropout=0.25)
    key = jax.random.key(seed)
    variables = model.init({"params": key, "dropout": key},
                           jnp.zeros((8, h.PATCH, h.PATCH, 3), jnp.float32),
                           jnp.ones((8,), bool))
    opt = optax.adam(2e-4)
    state = TrainState.create(variables["params"], opt)
    step = make_train_step(model, cross_entropy, opt, accumulation_steps=1)
    bags = [h.make_bag(1000 + i, positive=i % 2 == 0)[0] for i in range(24)]
    for epoch in range(14):
        correct = 0.0
        for i, bag in enumerate(bags):
            k = jax.random.fold_in(jax.random.fold_in(key, epoch), i)
            state, out = step(state, bag, k, jnp.asarray(True))
            correct += float(out["correct"])
    params = state.params
    clear = [h.mc_stats(model, params, h.make_bag(2000 + i, positive=i % 2 == 0)[0], seed=i)[1:3]
             for i in range(8)]
    ambig = [h.mc_stats(model, params, h.make_bag(3000 + i, positive=True, amp=0.28)[0],
                        seed=100 + i)[1:3] for i in range(8)]
    clear, ambig = np.mean(clear, axis=0), np.mean(ambig, axis=0)
    mass, spread = [], []
    for i in range(8):
        bag, lesion = h.make_bag(4000 + i, positive=True)
        A = h.mc_stats(model, params, bag, seed=200 + i)[3][:, 1, :]
        mass.append(float(A.mean(0)[lesion].sum()) / (h.N_LESION / h.N_TILES))
        sd = A.std(0, ddof=1)
        spread.append(float(sd[lesion].mean()) / max(float(sd[~lesion].mean()), 1e-9))
    return (correct / 24, float(ambig[0] / clear[0]), float(ambig[1] / clear[1]),
            float(np.mean(mass)), float(np.mean(spread)))


def port_ratios(seed: int, device: str = "cuda") -> tuple[float, ...]:
    from montecarlo_gated_mil_tpu_torch.evaluation import uncertainty as u

    model, accs = u.train_toy_model(seed=seed, device=device)
    return (accs[-1], *u.uncertainty_ratios(model), *u.attention_ratios(model))


def main() -> int:
    from montecarlo_gated_mil_tpu_torch.evaluation import uncertainty as u

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    ap.add_argument("--packages", default="jax,port", help="jax, port or both")
    ap.add_argument("--device", default="cuda", help="the port's device")
    args = ap.parse_args()
    runs = {"jax": jax_ratios, "port": lambda seed: port_ratios(seed, args.device)}
    passed = {package: [] for package in args.packages.split(",")}
    for seed in (int(s) for s in args.seeds.split(",")):
        for package in passed:
            r = runs[package](seed)
            values, oks = u.criteria(r[:1], r[1:])
            where = "cpu" if package == "jax" else args.device
            print(f"{package} ({where}) seed {seed}: {u.describe(values, oks)}", flush=True)
            if all(oks):
                passed[package].append(seed)
    for package, seeds in passed.items():
        print(f"{package}: all five criteria met at {len(seeds)} seeds {seeds}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
