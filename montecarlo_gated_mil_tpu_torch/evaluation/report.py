"""Classification report, in numpy.

Counterpart of ``montecarlo_gated_mil_tpu/evaluation/report.py``, which
calls scikit-learn's ``classification_report`` (target names
Negative/Positive, reference ``net_utils.py:180,218``).  The port has no
scikit-learn, so this computes the same numbers with the same formulas
(precision ``tp / predicted``, recall ``tp / true``, F1
``2 tp / (2 tp + fn + fp)``, 0 where a denominator is 0, macro and
support-weighted averages, accuracy as the micro average) and lays out the
same text.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_HEADERS = ("precision", "recall", "f1-score", "support")


class Report(str):
    """Classification-report text that also carries the dict form (per-class
    precision/recall/F1/support, ``accuracy``, ``macro avg``,
    ``weighted avg``)."""

    data: dict

    def __new__(cls, text: str, data: dict) -> "Report":
        obj = super().__new__(cls, text)
        obj.data = data
        return obj


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))


def _average(x: np.ndarray, weights: np.ndarray | None) -> float:
    if weights is None or np.sum(weights) == 0:
        return float(np.mean(x))
    return float(np.average(x, weights=weights))


def classification_report(
    targets: Sequence[int],
    preds: Sequence[int],
    target_names: tuple[str, str] = ("Negative", "Positive"),
    digits: int = 2,
) -> Report:
    """Text + dict report over labels 0 and 1 (both rows always shown)."""
    y, p = np.asarray(list(targets), np.int64), np.asarray(list(preds), np.int64)
    labels = np.arange(len(target_names))
    tp = np.array([np.sum((y == c) & (p == c)) for c in labels])
    pred_sum = np.array([np.sum(p == c) for c in labels])
    true_sum = np.array([np.sum(y == c) for c in labels])

    def prf(tp, pred_sum, true_sum):
        return (
            _divide(tp, pred_sum),
            _divide(tp, true_sum),
            _divide(2.0 * tp, 1.0 * true_sum + pred_sum),
        )

    prec, rec, f1 = prf(tp, pred_sum, true_sum)
    # scikit-learn's counts turn float when no prediction is right, and its
    # text then shows the support as a float too.
    support = true_sum.astype(np.float64) if tp.sum() == 0 else true_sum
    rows = list(zip(target_names, prec, rec, f1, support))
    total = support.sum()
    micro = [float(v[0]) for v in prf(tp.sum(keepdims=True), pred_sum.sum(keepdims=True),
                                        true_sum.sum(keepdims=True))]
    averages = {
        "accuracy": micro,
        "macro avg": [_average(v, None) for v in (prec, rec, f1)],
        "weighted avg": [_average(v, true_sum) for v in (prec, rec, f1)],
    }

    data = {
        name: dict(zip(_HEADERS, (float(a), float(b), float(c), float(s))))
        for name, a, b, c, s in rows
    }
    for name, avg in averages.items():
        data[name] = dict(zip(_HEADERS, [*avg, float(total)]))
    data["accuracy"] = data["accuracy"]["precision"]

    width = max(max(len(n) for n in target_names), len("weighted avg"), digits)
    text = ("{:>{width}s} " + " {:>9}" * 4).format("", *_HEADERS, width=width) + "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in rows:
        text += row_fmt.format(*row, width=width, digits=digits)
    text += "\n"
    for name, avg in averages.items():
        if name == "accuracy":
            fmt = "{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n"
            text += fmt.format(name, "", "", avg[2], total, width=width, digits=digits)
        else:
            text += row_fmt.format(name, *avg, total, width=width, digits=digits)
    return Report(text, data)
