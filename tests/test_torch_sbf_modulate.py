"""Kernel B's plain version (pamnet_tpu_torch/ops/sbf_modulate.py) against
the JAX package's fused sbf gather (pamnet_tpu/models/layers.py
_fused_sbf_gather) on the same numpy inputs.  Tolerance rtol 1e-5 /
atol 1e-6: the same f32 operations, in a possibly different order."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pamnet_tpu.models.layers import FoldedSBF, _fused_sbf_gather
from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate, sbf_modulate_plain


def _inputs(rng, d, ns=7, edges=300, triplets=1024):
    f32 = np.float32
    bound = 1.0 / np.sqrt(d)
    return dict(
        proj=rng.standard_normal((edges, ns * d)).astype(f32),
        m=rng.standard_normal((edges, d)).astype(f32),
        cbf=rng.standard_normal((triplets, ns)).astype(f32),
        bias=rng.standard_normal(d).astype(f32),
        # JAX layout (in, out).
        w1=rng.uniform(-bound, bound, (d, d)).astype(f32),
        b1=rng.uniform(-bound, bound, d).astype(f32),
        w2=rng.uniform(-bound, bound, (d, d)).astype(f32),
        b2=rng.uniform(-bound, bound, d).astype(f32),
        idx=rng.integers(0, edges, triplets).astype(np.int32),
        mask=(np.arange(triplets) < triplets - 100).astype(f32),
    )


def _port_args(x):
    t = torch.from_numpy
    return (t(x["proj"]), t(x["m"]), t(x["cbf"]), t(x["bias"]),
            t(np.ascontiguousarray(x["w1"].T)), t(x["b1"]),
            t(np.ascontiguousarray(x["w2"].T)), t(x["b2"]), t(x["idx"]),
            t(x["mask"]))


@pytest.mark.parametrize("d", [16, 8])
def test_plain_matches_fused_sbf_gather(d):
    x = _inputs(np.random.default_rng(d), d)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    p = {"mlp_sbf": [{"w": j["w1"], "b": j["b1"]}, {"w": j["w2"], "b": j["b2"]}]}
    want = np.asarray(_fused_sbf_gather(
        p, j["m"], FoldedSBF(j["proj"], j["cbf"], j["bias"]), j["idx"], j["mask"]))
    got = sbf_modulate_plain(*_port_args(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[-100:] == 0.0)  # masked triplets are exact zeros


def test_wrapper_takes_plain_version_on_cpu():
    args = _port_args(_inputs(np.random.default_rng(3), 16))
    before = sbf_modulate.launches
    np.testing.assert_array_equal(sbf_modulate(*args).numpy(),
                                  sbf_modulate_plain(*args).numpy())
    assert sbf_modulate.launches == before
