"""The port's parameters and scoring service on the CPU: JAX parameters map
onto the reference state-dict names, reference ``.pt`` files load, the HTTP
routes answer as direct scoring does, concurrent requests build their graphs
at once and score bit for bit as one at a time, the high-water pads lose no
widening, and nothing runs on the CPU unless it was asked for."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import dataclasses
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import torch

from pamnet_tpu.config import PAMNetConfig as JaxConfig
from pamnet_tpu.data.synthetic import synthetic_rna_dataset
from pamnet_tpu.models import init_pamnet
from pamnet_tpu.train.checkpoint import params_to_torch, save_torch_checkpoint
from pamnet_tpu_torch import serve
from pamnet_tpu_torch.config import PAMNetConfig, resolve_device
from pamnet_tpu_torch.data import structcache
from pamnet_tpu_torch.data.batch import PadSizes
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import rna_like_structure
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.weights import (
    from_jax_params,
    init_params,
    load_reference_checkpoint,
)

RNA = dict(dataset="rna_serve", dim=16, n_layer=1, cutoff_l=2.6,
           cutoff_g=20.0, flow="target_to_source")


@pytest.fixture(scope="module")
def jax_params():
    return init_pamnet(jax.random.PRNGKey(0), JaxConfig(**RNA))


@pytest.fixture(scope="module")
def mols():
    return [dict(z=g["labels"].astype(np.int32), pos=g["attrs"], y=g["y"])
            for g in synthetic_rna_dataset(3, seed=3)]


@pytest.fixture(scope="module")
def service():
    state = init_params(PAMNetConfig(**RNA), torch.Generator().manual_seed(1))
    return serve.RNAScoringService(state, PAMNetConfig(**RNA), batch_size=2,
                                   device="cpu")


def test_from_jax_params_uses_reference_names(jax_params):
    ref = {k: torch.tensor(v) for k, v in params_to_torch(jax_params).items()}
    model = PAMNet(PAMNetConfig(**RNA))
    model.load_state_dict(ref, strict=True)
    ours = from_jax_params(jax_params)
    assert ours.keys() == ref.keys()
    for k in ref:
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0, msg=k)
    model.load_state_dict(ours, strict=True)


def test_reference_checkpoint_loads(jax_params, tmp_path):
    """A legacy-format torch pickle as the reference writes it."""
    path = str(tmp_path / "pamnet_rna.pt")
    save_torch_checkpoint(path, jax_params)
    got = load_reference_checkpoint(path)
    want = from_jax_params(jax_params)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_init_params_distributions():
    cfg = PAMNetConfig(**RNA)
    a = init_params(cfg, torch.Generator().manual_seed(7))
    b = init_params(cfg, torch.Generator().manual_seed(7))
    c = init_params(cfg, torch.Generator().manual_seed(8))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embeddings"], c["embeddings"])
    torch.testing.assert_close(a["rbf_g.freq"], torch.arange(1, 17) * np.pi,
                               check_dtype=False)
    assert a["embeddings"].abs().max() <= np.sqrt(3.0)
    w = a["global_layer.0.mlp_m.0.0.weight"]  # (16, 48)
    assert w.shape == (16, 48) and w.abs().max() <= 1 / np.sqrt(48)
    assert a["global_layer.0.mlp_m.0.0.bias"].abs().max() <= 1 / np.sqrt(48)
    assert a["local_layer.0.W"].abs().max() <= np.sqrt(6.0 / 17)


def _post(url, data: bytes, ctype: str) -> dict:
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _pdb_text(z, pos) -> str:
    elem = "CNO"
    lines = [
        f"ATOM  {i:5d}  {elem[zi]:<3s}  G A{i:4d}    "
        f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}  1.00  0.00           {elem[zi]}"
        for i, (zi, p) in enumerate(zip(z, pos))
    ]
    return "\n".join(lines) + "\nTER\n"


def test_service_matches_direct_scoring(service, mols):
    scores = service.score_molecules(mols)
    gb = next(iter(GraphLoader(mols, "rna", 2.6, 20.0, batch_size=4,
                               ladder_pads=True)))
    with torch.inference_mode():
        direct = service.model(gb).numpy()[:3]
    assert scores.shape == (3,) and np.all(np.isfinite(scores))
    np.testing.assert_allclose(scores, direct, rtol=0, atol=1e-6)


def test_http_routes(service, mols):
    server = serve.make_server(service, "127.0.0.1", 0, "seed 1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["ok"] is True and health["device"] == "cpu"

        body = json.dumps({"molecules": [
            {"name": f"m{i}", "z": m["z"].tolist(), "pos": m["pos"].tolist()}
            for i, m in enumerate(mols)
        ]}).encode()
        res = _post(f"{base}/score", body, "application/json")
        assert res["names"] == ["m0", "m1", "m2"]
        np.testing.assert_allclose(res["scores"], service.score_molecules(mols),
                                   rtol=0, atol=1e-6)

        z = mols[0]["z"]
        pos = np.round(mols[0]["pos"].astype(np.float64), 3)
        got = _post(f"{base}/score?name=frag", _pdb_text(z, pos).encode(),
                    "chemical/x-pdb")
        assert got["names"] == ["frag"]
        want = service.score_molecules([dict(z=z, pos=pos)])[0]
        assert abs(got["scores"][0] - want) < 1e-6

        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{base}/score", b'{"molecules": [{}]}', "application/json")
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_rejects_bad_input(service, mols):
    bad = dict(mols[0])
    bad["z"] = mols[0]["z"] + 6  # atomic numbers instead of TU codes
    with pytest.raises(ValueError, match="atom codes"):
        service.score_molecules([bad])
    with pytest.raises(ValueError, match="pos"):
        service.score_molecules([dict(z=[0, 1], pos=[[0.0, 0.0, 0.0]])])
    with pytest.raises(ValueError, match="no C/N/O"):
        serve.pdb_text_to_molecule("HETATM    1 MG   MG A   1       0.000"
                                   "   0.000   0.000  1.00  0.00          MG\n")


def _fresh_service() -> serve.RNAScoringService:
    cfg = PAMNetConfig(**RNA)
    return serve.RNAScoringService(init_params(cfg, torch.Generator().manual_seed(1)), cfg,
                                   batch_size=2, device="cpu")


def _requests(sizes: list[list[int]], seed: int = 5) -> list[list[dict]]:
    """One request a list of atom counts: molecules of those sizes."""
    rng = np.random.default_rng(seed)
    return [[rna_like_structure(rng, n) for n in req] for req in sizes]


def _concurrently(calls, timeout: float = 120.0) -> list:
    """Each call in a thread of its own, all started together; their
    results in order (a call's exception is raised here)."""
    results: list = [None] * len(calls)

    def run(k, fn):
        try:
            results[k] = (True, fn())
        except Exception as e:  # noqa: BLE001 - raised in the test's thread
            results[k] = (False, e)

    threads = [threading.Thread(target=run, args=(k, fn)) for k, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)
    for ok, value in results:
        if not ok:
            raise value
    return [value for _, value in results]


def test_concurrent_requests_build_their_graphs_at_once(monkeypatch):
    """Each graph build waits for a second one to start: both requests
    finish only if neither build runs under the other's lock."""
    service, (a, b) = _fresh_service(), _requests([[30], [40]])
    barrier = threading.Barrier(2, timeout=30)
    build = structcache.build_structures

    def meeting(mols, spec):
        barrier.wait()
        return build(mols, spec)

    monkeypatch.setattr(structcache, "build_structures", meeting)
    got = _concurrently([lambda: service.score_molecules(a),
                         lambda: service.score_molecules(b)], timeout=60)
    assert [g.shape for g in got] == [(1,), (1,)]
    assert all(np.all(np.isfinite(g)) for g in got)


def test_concurrent_scores_are_the_serial_scores():
    """8 requests from 4 threads score bit for bit as the same requests one
    at a time on a fresh service, once a warm-up has settled the pads."""
    warmup = _requests([[70, 65, 60]], seed=4)[0]
    reqs = _requests([[30], [45, 35], [60], [25, 55], [50], [40, 30], [35], [65, 20]])
    concurrent, serial = _fresh_service(), _fresh_service()
    for service in (concurrent, serial):
        service.score_molecules(warmup)
    settled = concurrent._pads

    def client(w):
        return [concurrent.score_molecules(r) for r in reqs[w::4]]

    by_client = _concurrently([lambda w=w: client(w) for w in range(4)])
    got = [by_client[k % 4][k // 4] for k in range(len(reqs))]
    want = [serial.score_molecules(r) for r in reqs]
    assert concurrent._pads == serial._pads == settled
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (len(reqs[k]),) and np.array_equal(g, w), k


def test_the_high_water_pads_are_every_requests_max(monkeypatch):
    """After concurrent requests of different sizes the service's pads are
    the element-wise max of every request's loader pads."""
    pads = []

    class Recorded(GraphLoader):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            pads.append(self.pads)

    monkeypatch.setattr(serve, "GraphLoader", Recorded)
    service = _fresh_service()
    reqs = _requests([[80], [20, 25], [30, 75], [50], [45, 40], [90]], seed=6)
    _concurrently([lambda r=r: service.score_molecules(r) for r in reqs])
    assert len(pads) == len(reqs)
    fields = [f.name for f in dataclasses.fields(PadSizes)]
    assert service._pads == PadSizes(*(max(getattr(p, f) for p in pads) for f in fields))


def test_pads_widen_without_a_lost_update():
    """More threads than cores widen the pads at once, the interpreter
    switching threads every microsecond: no widening is lost."""
    service = _fresh_service()
    threads_n, each = 4 * (os.cpu_count() or 1), 200
    rng = np.random.default_rng(0)
    offered = [[PadSizes(*(int(v) for v in rng.integers(1, 10 ** 6, 6))) for _ in range(each)]
               for _ in range(threads_n)]

    def widen(mine):
        for p in mine:
            service._widen_pads(p)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _concurrently([lambda m=m: widen(m) for m in offered], timeout=60)
    finally:
        sys.setswitchinterval(interval)
    every = [p for mine in offered for p in mine]
    assert service._pads == PadSizes(*(max(vals) for vals in
                                       zip(*(dataclasses.astuple(p) for p in every))))


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PAMNetConfig(**RNA)
    state = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.RNAScoringService(state, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--seed", "0"])
    assert resolve_device("cpu") == torch.device("cpu")
