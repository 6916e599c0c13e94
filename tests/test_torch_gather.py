"""The row-gather kernels' plain versions (pamnet_tpu_torch/ops/gather.py)
against the JAX package on the same numpy inputs: the row gather against
``jnp.take`` (the function of the Pallas probes in tools/vmem_gather_probe.py,
at their shapes), the edge message against ``pamnet_tpu.models.layers.
_edge_message`` and the global layer's gated, masked message.  Gathers are
exact; messages rtol 1e-5 / atol 1e-6 (the same f32 operations)."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pamnet_tpu.models.layers import _edge_message as jax_edge_message
from pamnet_tpu_torch.models.layers import _edge_message
from pamnet_tpu_torch.nn import mlp
from pamnet_tpu_torch.ops._build import check_operand
from pamnet_tpu_torch.ops.gather import (edge_message, edge_message_plain, row_gather,
                                         row_gather_plain)


@pytest.mark.parametrize("rows,cols,n_idx", [
    (256, 128, 512),    # probe_take_1d
    (256, 128, 256),    # probe_dynamic_gather
    (4096, 128, 2048),  # probe_fori_rate's table, fewer rows
    (3, 16, 100),       # the atom-type embedding lookup
    (50, 42, 300),      # the unfolded path's radial table
])
def test_row_gather_plain_matches_take(rows, cols, n_idx):
    rng = np.random.default_rng(rows + cols)
    src = rng.standard_normal((rows, cols)).astype(np.float32)
    idx = rng.integers(0, rows, n_idx).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(src), jnp.asarray(idx), axis=0))
    got = row_gather_plain(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def _message_inputs(rng, nodes=40, edges=300, d=16):
    f32 = np.float32
    bound = 1.0 / np.sqrt(3 * d)
    return dict(
        x=rng.standard_normal((nodes, d)).astype(f32),
        e=rng.standard_normal((edges, d)).astype(f32),
        w=rng.uniform(-bound, bound, (3 * d, d)).astype(f32),  # JAX (in, out)
        b=rng.uniform(-bound, bound, d).astype(f32),
        gate=rng.standard_normal((edges, d)).astype(f32),
        mask=(np.arange(edges) < edges - 37).astype(f32),
        i=rng.integers(0, nodes, edges).astype(np.int32),
        j=rng.integers(0, nodes, edges).astype(np.int32),
    )


@pytest.mark.parametrize("gated,masked", [(False, False), (True, False), (True, True)],
                         ids=["m_ji", "m_kj", "global"])
def test_edge_message_matches_jax(gated, masked):
    x = _message_inputs(np.random.default_rng(7 + gated + masked))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want = jax_edge_message([{"w": j["w"], "b": j["b"]}], j["x"], j["e"], j["i"], j["j"],
                            None)
    if gated:
        want = want * j["gate"]
    if masked:
        want = want * j["mask"][:, None]

    m = mlp([48, 16])
    with torch.no_grad():
        m[0][0].weight.copy_(torch.from_numpy(x["w"].T))
        m[0][0].bias.copy_(torch.from_numpy(x["b"]))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.inference_mode():
        got = _edge_message(m, t["x"], t["e"], t["i"], t["j"],
                            t["gate"] if gated else None, t["mask"] if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if masked:
        assert np.all(got.numpy()[-37:] == 0.0)


def test_wrappers_take_plain_versions_on_cpu():
    x = {k: torch.from_numpy(v) for k, v in _message_inputs(np.random.default_rng(3)).items()}
    before = row_gather.launches, edge_message.launches
    np.testing.assert_array_equal(row_gather(x["x"], x["i"]).numpy(),
                                  row_gather_plain(x["x"], x["i"]).numpy())
    args = (x["x"], x["x"] * 2, x["i"], x["j"], x["e"], x["gate"], x["mask"])
    np.testing.assert_array_equal(edge_message(*args).numpy(),
                                  edge_message_plain(*args).numpy())
    assert (row_gather.launches, edge_message.launches) == before


def test_kernel_operand_check():
    """The wrappers' common check: a 4-byte-offset view would misalign the
    kernels' 16-byte loads, and a non-CUDA device has no kernel."""
    cuda = torch.device("cuda")
    view = torch.zeros(65)[1:].view(8, 8)
    with pytest.raises(ValueError, match="misaligned"):
        check_operand("k", "a", view, torch.float32, cuda, (8, 8))
    with pytest.raises(ValueError, match=r"\(\*, 8\) tensor on cpu"):
        check_operand("k", "a", torch.zeros(8, 4), torch.float32, torch.device("cpu"),
                      (None, 8))
