"""The uncertainty acceptance's figure and its numbers, over training seeds.

Counterpart of the JAX package's ``tools/validate_uncertainty.py``: it runs
the port's acceptance harness (``evaluation/uncertainty.py``: the toy r18
model trained on synthetic 16-tile lesion bags by ``train_toy_model``, then
T=30 MC samples per bag) at the JAX test's size and renders the evidence
that the MC uncertainty is informative in four panels:

  A. predictive MC std (ddof=0 over T of P(class 1)) per bag, clear negative,
     clear positive and constructed-ambiguous bags;
  B. predictive entropy of the mean softmax per bag, the same bags;
  C. class-1 attention mass on the lesion tiles per clear positive bag,
     against the uniform share;
  D. MC attention std (ddof=1) on the background and on the lesion tiles,
     paired per bag.

It prints the summary numbers and the acceptance's five criteria
(``uncertainty.criteria``) per seed; with several seeds (``--seeds 0-11``)
a table of which criteria each seed meets, and the figure of the first
seed.  The figure needs matplotlib; ``--no-figure`` prints the numbers
alone (the card's machine has no matplotlib).

    python -m montecarlo_gated_mil_tpu_torch.tools.validate_uncertainty [--seeds 0] \\
        [--out tool_out/uncertainty_validation.png]
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from montecarlo_gated_mil_tpu_torch.evaluation import uncertainty as u
from montecarlo_gated_mil_tpu_torch.tools import _common

DEFAULT_OUT = os.path.join("tool_out", "uncertainty_validation.png")
# The JAX tool's palette: clear bags blue, ambiguous orange, and the chart's
# chrome.
BLUE, ORANGE = "#2a78d6", "#eb6834"
INK, INK2, MUTED, GRID, SURFACE = "#0b0b0b", "#52514e", "#898781", "#e1e0d9", "#fcfcfb"


def seeds(text: str) -> list[int]:
    """``"0-11"`` or ``"0,3,5"`` -> the seeds (argparse type)."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def evaluate(model) -> dict:
    """What the panels show, per bag (``uncertainty.predictive_values`` and
    ``lesion_attention``), and the acceptance's four ratios of those
    numbers (``spread_ratios``, ``lesion_ratios``)."""
    clear, ambig = u.predictive_values(model)
    attention = u.lesion_attention(model)
    return dict(clear=clear, ambig=ambig, mass=attention[0], lesion_std=attention[1],
                background_std=attention[2],
                ratios=(*u.spread_ratios(clear, ambig), *u.lesion_ratios(*attention)))


def _style(ax, title: str) -> None:
    ax.set_facecolor(SURFACE)
    ax.set_title(title, fontsize=10, color=INK, loc="left")
    ax.tick_params(colors=MUTED, labelsize=8)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color("#c3c2b7")
    ax.grid(axis="y", color=GRID, linewidth=0.7)
    ax.set_axisbelow(True)


def _strip(ax, groups, ylabel: str) -> None:
    """A jittered dot strip per group with its mean as a tick and a label."""
    rng = np.random.default_rng(7)
    for i, (name, vals, color) in enumerate(groups):
        x = i + rng.uniform(-0.12, 0.12, len(vals))
        ax.plot(x, vals, "o", ms=5, color=color, mec=SURFACE, mew=0.8, alpha=0.9)
        m = float(np.mean(vals))
        ax.hlines(m, i - 0.24, i + 0.24, color=color, linewidth=2)
        ax.annotate(f"{m:.3f}", (i + 0.28, m), fontsize=8, color=INK2, va="center")
    ax.set_xticks(range(len(groups)))
    ax.set_xticklabels([g[0] for g in groups], fontsize=8, color=INK2)
    ax.set_xlim(-0.5, len(groups) - 0.2)
    ax.set_ylabel(ylabel, fontsize=8, color=INK2)


def render(panels: dict, out: str, title: str) -> None:
    """The four panels (module docstring) as a PNG at ``out``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_a, ax_b, ax_c, ax_d) = plt.subplots(1, 4, figsize=(12.5, 3.2), facecolor=SURFACE)
    for ax, col, ylabel, name in ((ax_a, 1, "MC std of P(class 1), ddof=0",
                                   "A  Predictive MC spread"),
                                  (ax_b, 2, "entropy of mean softmax (nats)",
                                   "B  Predictive entropy")):
        _strip(ax, [("clear\nnegative", panels["clear"][1::2, col], BLUE),
                    ("clear\npositive", panels["clear"][0::2, col], BLUE),
                    ("ambiguous", panels["ambig"][:, col], ORANGE)], ylabel)
        _style(ax, name)
    uniform = u.N_LESION / u.N_TILES
    mass = panels["mass"]
    x = np.arange(len(mass))
    ax_c.bar(x, mass, width=0.55, color=BLUE, edgecolor=SURFACE, linewidth=1)
    ax_c.axhline(uniform, color=MUTED, linestyle=(0, (4, 3)), linewidth=1.2)
    ax_c.annotate(f"uniform share ({u.N_LESION}/{u.N_TILES})", (len(mass) - 0.4, uniform),
                  fontsize=8, color=INK2, va="bottom", ha="right")
    ax_c.set_xticks(x)
    ax_c.set_xticklabels([str(i + 1) for i in x], fontsize=8, color=INK2)
    ax_c.set_xlabel("clear positive bag", fontsize=8, color=INK2)
    ax_c.set_ylabel("attention mass on lesion tiles", fontsize=8, color=INK2)
    _style(ax_c, "C  Attention finds the lesions")
    for b, s in zip(panels["background_std"], panels["lesion_std"]):
        ax_d.plot([0, 1], [b, s], "-", color=GRID, linewidth=1, zorder=1)
        ax_d.plot(0, b, "o", ms=5, color=BLUE, mec=SURFACE, mew=0.8, zorder=2)
        ax_d.plot(1, s, "o", ms=5, color=ORANGE, mec=SURFACE, mew=0.8, zorder=2)
    ax_d.set_xticks([0, 1])
    ax_d.set_xticklabels(["background\ntiles", "lesion\ntiles"], fontsize=8, color=INK2)
    ax_d.set_xlim(-0.4, 1.4)
    ax_d.set_ylabel("MC attention std (ddof=1 over T)", fontsize=8, color=INK2)
    _style(ax_d, "D  MC spread concentrates on lesions")
    fig.suptitle(title, fontsize=11, color=INK, x=0.01, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.92))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fig.savefig(out, dpi=160, facecolor=SURFACE, bbox_inches="tight")
    plt.close(fig)


def main(argv=None, *, device="cuda") -> dict:
    ap = _common.parser(__doc__)
    ap.add_argument("--seeds", type=seeds, default=[0],
                    help="training seeds, e.g. 0 or 0-11 (the acceptance's is 0)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="the figure (PNG) of the first seed")
    ap.add_argument("--no-figure", action="store_true", help="print the numbers only")
    ap.add_argument("--bags", type=int, default=24, help="training bags (the acceptance's 24)")
    ap.add_argument("--epochs", type=int, default=14, help="training epochs (the acceptance's 14)")
    args = ap.parse_args(argv)
    if not args.no_figure and importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("validate_uncertainty: the figure needs matplotlib, which is not "
                         "installed; --no-figure prints the numbers alone")
    device = _common.start(device)
    results = {}
    for seed in args.seeds:
        model, accs = u.train_toy_model(args.bags, args.epochs, seed=seed, device=device)
        panels = evaluate(model)
        values, oks = u.criteria(accs, panels["ratios"])
        results[seed] = dict(accuracies=accs, panels=panels, values=values, oks=oks)
        print(f"seed {seed}: train accuracy by epoch {[round(a, 2) for a in accs]}", flush=True)
        print(f"seed {seed}: {u.describe(values, oks)}", flush=True)
        if seed == args.seeds[0]:
            _summary(panels)
            if args.no_figure:
                print("figure: not drawn (--no-figure)", flush=True)
            else:
                render(panels, args.out, "MC-dropout uncertainty is informative (synthetic "
                       f"lesion bags, T={u.T}, training seed {seed}, {device.type})")
                print(f"figure: wrote {args.out}", flush=True)
    if len(args.seeds) > 1:
        _table(results)
    return results


def _summary(panels: dict) -> None:
    clear = panels["clear"]
    uniform = u.N_LESION / u.N_TILES
    c_std, a_std = np.mean(clear[:, 1]), np.mean(panels["ambig"][:, 1])
    c_ent, a_ent = np.mean(clear[:, 2]), np.mean(panels["ambig"][:, 2])
    mass = np.mean(panels["mass"])
    print(f"  MC std: clear {c_std:.4f} vs ambiguous {a_std:.4f} ({a_std / c_std:.1f}x)")
    print(f"  entropy: clear {c_ent:.4f} vs ambiguous {a_ent:.4f} ({a_ent / c_ent:.1f}x)")
    print(f"  attention mass on lesion tiles: {mass:.3f} (uniform {uniform:.3f}, "
          f"{mass / uniform:.1f}x)")
    print(f"  attention MC std lesion/background: "
          f"{np.mean(panels['lesion_std']) / np.mean(panels['background_std']):.2f}x "
          "(ratio of the means; the criterion takes the mean of the per-bag ratios)",
          flush=True)


def _table(results: dict) -> None:
    names = [n for n, _ in u.CRITERIA]
    print("\nper seed (pass / FAIL):")
    print("  seed | " + " | ".join(names) + " | all five")
    for seed, r in results.items():
        print(f"  {seed:4d} | " + " | ".join(
            f"{v:.3f} {'pass' if ok else 'FAIL'}" for v, ok in zip(r["values"], r["oks"]))
            + f" | {'yes' if all(r['oks']) else 'no'}")
    met = [s for s, r in results.items() if all(r["oks"])]
    print(f"  all five criteria met at {len(met)} of {len(results)} seeds: {met}", flush=True)


if __name__ == "__main__":
    main()
