"""RNA structure scoring service on the port (JAX counterpart:
``serve_rna.py``).

API (JSON unless noted):
  GET  /healthz
      -> {"ok": true, "model": <source>, "device": <device>}
  POST /score      Content-Type: application/json
      {"molecules": [{"name": "...", "z": [0,1,2,...], "pos": [[x,y,z],..]}]}
      (z in the TU convention: 0=C 1=N 2=O)
      -> {"names": [...], "scores": [...]}
  POST /score      any other Content-Type: raw PDB text of one structure
      (heavy C/N/O atoms; ?name=<tag> names the response)
      -> {"names": [<tag>], "scores": [<s>]}

Run: ``python -m pamnet_tpu_torch.serve --seed 0`` (random weights) or
``--saved_model pamnet_rna.pt``; ``--device`` defaults to ``cuda`` and the
service refuses to start without a card unless ``--device cpu`` is given.

Spans (``profiling.span``, recorded while a profile runs), on the handler's
thread, each with the request's id (the server's count of POSTs) as
``ref``: ``serve.request``, the whole POST from its body's read to the
reply's write, and inside it ``serve.parse`` (the body's read and parse),
``serve.validate``, ``serve.lock_wait`` (from before the service's lock
until it is held), the loader's ``loader.build`` and ``loader.collate``,
then per batch ``serve.h2d`` (the copy's issue), ``serve.forward`` (the
forward's issue) and ``serve.d2h`` (the copy back, which waits for the
forward), and ``serve.reply``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import threading

import numpy as np
import torch

from pamnet_tpu_torch.config import PAMNetConfig, resolve_device, set_matmul_precision
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.pdb import parse_pdb_atoms
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.profiling import span

_RNA_TYPES = {"C": 0, "N": 1, "O": 2}


def pdb_text_to_molecule(text: str) -> dict:
    """Heavy C/N/O atoms of one PDB structure as a TU-convention molecule."""
    elems, coords = parse_pdb_atoms(text.splitlines())
    keep = [i for i, e in enumerate(elems) if e in _RNA_TYPES]
    if not keep:
        raise ValueError("no C/N/O atoms in PDB input")
    z = np.asarray([_RNA_TYPES[elems[i]] for i in keep], np.int32)
    return dict(z=z, pos=coords[keep].astype(np.float32), y=0.0)


class RNAScoringService:
    """Model resident on ``device``; scoring is serialized, and the pads of
    every request widen a high-water bucket that later requests start from,
    so batch shapes stay on the geometric ladder."""

    def __init__(self, state_dict: dict, cfg: PAMNetConfig, batch_size: int = 16,
                 ladder_pads: bool = True, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # The JAX service scores at float32 matmul precision.
            set_matmul_precision()
        self.cfg = cfg
        self.batch_size = batch_size
        self.ladder_pads = ladder_pads
        model = PAMNet(cfg)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self._lock = threading.Lock()
        self._pads = None

    def _validate(self, mols: list[dict]) -> list[dict]:
        for i, m in enumerate(mols):
            if "z" not in m or "pos" not in m:
                raise ValueError(f"molecule {i}: need 'z' and 'pos'")
        mols = [dict(z=np.asarray(m["z"], np.int32),
                     pos=np.asarray(m["pos"], np.float32),
                     y=float(m.get("y", 0.0))) for m in mols]
        ntypes = self.cfg.num_atom_types
        for i, m in enumerate(mols):
            z, pos = m["z"], m["pos"]
            if z.ndim != 1 or pos.shape != (z.shape[0], 3):
                raise ValueError(
                    f"molecule {i}: 'pos' must be (len(z), 3), got z "
                    f"{z.shape} pos {pos.shape}"
                )
            if z.size and (z.min() < 0 or z.max() >= ntypes):
                raise ValueError(
                    f"molecule {i}: atom codes must be in [0, {ntypes}) "
                    f"(TU convention: 0=C 1=N 2=O), got "
                    f"[{int(z.min())}, {int(z.max())}]"
                )
        return mols

    def score_molecules(self, mols: list[dict]) -> np.ndarray:
        """(len(mols),) scores."""
        with span("serve.validate"):
            mols = self._validate(mols)
        cfg = self.cfg
        with span("serve.lock_wait"):
            self._lock.acquire()
        try:
            loader = GraphLoader(
                mols, cfg.dataset_kind, cfg.cutoff_l, cfg.cutoff_g,
                batch_size=self.batch_size, pads=self._pads,
                ladder_pads=self.ladder_pads, num_spherical=cfg.num_spherical,
                num_radial=cfg.num_radial,
                envelope_exponent=cfg.envelope_exponent,
            )
            self._pads = loader.pads
            out = []
            with torch.inference_mode():
                for gb in loader:
                    with span("serve.h2d"):
                        gb = gb.to(self.device)
                    with span("serve.forward"):
                        res = self.model(gb)
                    with span("serve.d2h"):
                        out.append(res[:gb.num_graphs].cpu().numpy())
        finally:
            self._lock.release()
        return np.concatenate(out)


def make_server(service: RNAScoringService, host: str, port: int,
                model_source: str):
    """A ThreadingHTTPServer wired to the service, returned unstarted."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    request_ids = itertools.count()

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._reply(200, {"ok": True, "model": model_source,
                                  "device": str(service.device)})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            with span("serve.request", next(request_ids)):
                self._post()

        def _post(self):
            parsed = urlparse(self.path)
            if parsed.path != "/score":
                with span("serve.reply"):
                    self._reply(404, {"error": "unknown path"})
                return
            try:
                with span("serve.parse"):
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    ctype = self.headers.get("Content-Type", "")
                    if ctype.startswith("application/json"):
                        mols = json.loads(body)["molecules"]
                        names = [m.get("name", f"molecule_{i}")
                                 for i, m in enumerate(mols)]
                    else:
                        q = parse_qs(parsed.query)
                        names = [q.get("name", ["structure"])[0]]
                        mols = [pdb_text_to_molecule(body.decode())]
                scores = service.score_molecules(mols)
                code, payload = 200, {"names": names, "scores": [float(s) for s in scores]}
            except Exception as e:  # noqa: BLE001 - reported to the client
                code, payload = 400, {"error": f"{type(e).__name__}: {e}"}
            with span("serve.reply"):
                self._reply(code, payload)

    return ThreadingHTTPServer((host, port), Handler)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8040)
    parser.add_argument("--n_layer", type=int, default=1)
    parser.add_argument("--dim", type=int, default=16)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--cutoff_l", type=float, default=2.6)
    parser.add_argument("--cutoff_g", type=float, default=20.0)
    parser.add_argument("--flow", type=str, default="target_to_source")
    weights = parser.add_mutually_exclusive_group(required=True)
    weights.add_argument("--saved_model", type=str,
                         help="reference .pt state dict")
    weights.add_argument("--seed", type=int, help="random weights from this seed")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--fixed_pads", action="store_true")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="float32 (the JAX service's default) or bfloat16 (the "
                             "folded dim-16 model through kernel B's bfloat16 version)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from pamnet_tpu_torch.weights import init_params, load_reference_checkpoint

    cfg = PAMNetConfig(dataset="rna_serve", dim=args.dim, n_layer=args.n_layer,
                       cutoff_l=args.cutoff_l, cutoff_g=args.cutoff_g,
                       flow=args.flow, compute_dtype=args.compute_dtype)
    if args.saved_model is not None:
        state, source = load_reference_checkpoint(args.saved_model), args.saved_model
    else:
        state = init_params(cfg, torch.Generator().manual_seed(args.seed))
        source = f"random weights, seed {args.seed}"
    service = RNAScoringService(state, cfg, batch_size=args.batch_size,
                                ladder_pads=not args.fixed_pads,
                                device=args.device)
    server = make_server(service, args.host, args.port, source)
    print(f"Model: {source} on {service.device}. "
          f"Serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
