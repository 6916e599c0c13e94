"""The numbers that decide ``correct``, and the controls in lower precision.

Training cells compare the program's first three steps with the
reference's (``reference/pamnet.py``) from the same weights on the same
molecules:

* ``loss_gap``: the widest of |loss_p - loss_r| / |loss_r| over the steps;
* ``grad_gap``: over the leaves, the widest gap between the norms of the
  first gradient as the optimizer got it, |‖g_p‖ - ‖g_r‖|, over the larger
  of ‖g_r‖ of that leaf and of the median leaf; ``grad_gap_median``, the
  median leaf's gap of the same;
* ``change_gap``: the same of the norms of each leaf's change over the
  three steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
  ``change_gap_median``, the median leaf's gap of the same.  A median is
  steady from seed to seed where one small leaf's reading is noise (Adam's
  first steps move each element by about lr times the sign of its
  gradient, so an element whose gradient is all but zero moves by the sign
  of its round-off).
* ``ema_gap`` and ``ema_gap_median``: where the recipe keeps an EMA of the
  parameters, the same of each leaf's EMA change over the three steps;
* ``eval_gap``: the window's last evaluation, a seeded sample of the
  predictions it made, against the reference's forward of the same
  molecules with the weights that evaluation read (the EMA for QM9): the
  widest |p_p - p_r| over the larger of |p_r| and the median |p_r|;
  ``eval_gap_median``, the median prediction's gap of the same (steady
  from seed to seed where the widest of hundreds of bfloat16 predictions
  swings).  Those weights are the program's state after the window; the
  start that they skip is checked by the numbers above.
A cell compares the numbers its ``limits`` name.

Score cells compare the scores the clients received with the reference's
scores of the same PDB text: ``score_gap``, the widest |s_p - s_r| over
the larger of |s_r| and the median |s_r|.  Every cell also holds
``failed`` (a request sent in the window that got no score, a step whose
loss is not finite) to 0.

A control is the reference computed below the configuration's precision:
TF32 products for a float32 configuration (TF32 off), float8 (e4m3,
saturating) for a bfloat16 one, by ``control``.
"""

from __future__ import annotations

import contextlib

import torch


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_norm_gaps(got: dict, want: dict, keep=None) -> dict[str, float]:
    """Each leaf's gap between the norms of ``got`` and ``want`` over the
    larger of its reference norm and the median leaf's (module docstring)."""
    names = [k for k in want if keep is None or keep(k)]
    ref = {k: float(want[k].double().norm()) for k in names}
    median = sorted(ref.values())[len(ref) // 2]
    return {k: abs(float(got[k].double().norm()) - ref[k]) / max(ref[k], median, 1e-30)
            for k in names}


def moving_leaves(ref_grads: dict) -> set:
    """The leaves whose reference gradient norm is at least a thousandth of
    the median leaf's."""
    norms = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {k for k, v in norms.items() if v >= 1e-3 * median}


def train_gaps(prog: dict, ref: dict) -> dict:
    """The numbers of a training cell from the program's and the
    reference's ``losses``, ``grads`` (first step) and ``change``."""
    loss = max(rel_gap(p, r) for p, r in zip(prog["losses"], ref["losses"]))
    grads = leaf_norm_gaps(prog["grads"], ref["grads"])
    change = leaf_norm_gaps(prog["change"], ref["change"], moving_leaves(ref["grads"]).__contains__)
    worst = lambda gaps: max(gaps, key=gaps.get)  # noqa: E731
    median = lambda gaps: sorted(gaps.values())[len(gaps) // 2]  # noqa: E731
    out = {"loss_gap": loss, "grad_gap": grads[worst(grads)], "grad_gap_median": median(grads),
           "change_gap": change[worst(change)], "change_gap_median": median(change),
           "grad_leaf": worst(grads), "change_leaf": worst(change)}
    if "ema_change" in ref:
        ema = leaf_norm_gaps(prog["ema_change"], ref["ema_change"],
                             moving_leaves(ref["grads"]).__contains__)
        out.update(ema_gap=ema[worst(ema)], ema_gap_median=median(ema), ema_leaf=worst(ema))
    return out


def score_gaps(got, want) -> list[float]:
    """Each |got - want| over the larger of |want| and the median |want|."""
    scale = sorted(abs(w) for w in want)[len(want) // 2]
    return [abs(g - w) / max(abs(w), scale, 1e-30) for g, w in zip(got, want)]


def score_gap(got, want) -> float:
    """The widest of ``score_gaps``."""
    return max(score_gaps(got, want))


def eval_gaps(got, want) -> dict:
    """``eval_gap`` and ``eval_gap_median`` of a training cell's evaluation."""
    gaps = sorted(score_gaps(got, want))
    return {"eval_gap": gaps[-1], "eval_gap_median": gaps[len(gaps) // 2]}


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 (saturating at +-448), kept in its type;
    the gradient passes the rounding unchanged (straight through), as a
    product in float8 with float32 accumulation differentiates."""
    rounded = t.detach().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(t.dtype)
    return t + (rounded - t.detach())


@contextlib.contextmanager
def precision(name: str):
    """The reference's precision inside the block: "float32" (TF32 off),
    "tf32" (TF32 products), or "fp8" (yields the rounding the reference's
    ``quant`` applies); yields that ``quant`` (None unless fp8)."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = name == "tf32"
    try:
        yield fp8 if name == "fp8" else None
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def control_precision(cfg: dict) -> str:
    """The nearest precision below the configuration's."""
    return "fp8" if cfg["compute_dtype"] == "bfloat16" else "tf32"
