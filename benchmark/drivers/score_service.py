"""Traffic driver: the RNA scoring service under closed-loop clients.

The service runs in the run's process as ``python -m pamnet_tpu_torch.serve
--seed`` sets it up (``RNAScoringService`` behind ``serve.make_server`` on
an ephemeral localhost port, the seed's weights, the configuration's batch
size and ladder pads); ``clients`` closed-loop clients with no think time
run in a child process (``score_clients.py``), each posting the raw PDB
text of one structure to ``/score`` and sending its next one when the
reply has come.  Every body is a seeded rigid copy of one of ``bases``
base structures (the same for every run, from ``base_seed``) with its own
jitter, built in the child ahead of sending;
``warmup_requests`` others settle the ladder pads before the window.

A request counts when its whole reply came inside the window; a request
sent in the window whose reply was not a score counts as failed.  In the
traced run the ``GraphLoader`` that ``serve.py`` binds is wrapped, so its
construction (the host graph build) and its collations are host spans.

Traffic parameters: ``clients``, ``bases``, ``base_seed``, ``n_atoms``,
``warmup_requests``, ``prebuild`` (bodies the child keeps built ahead),
``sample`` (requests the check compares), ``request_timeout_s``.
"""

from __future__ import annotations

import multiprocessing
import threading
import time

import numpy as np
import torch

from benchmark import weights
from benchmark.drivers import score_clients
from benchmark.reference import steps as ref_steps

_READY_TIMEOUT_S = 600


class Cell:
    def __init__(self, cell: dict, cfg: dict, seed: int, device, traced: bool):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.device, self.traced = torch.device(device), traced
        self.spans: list = []
        self.idle_label = "service: HTTP, parse, lock, forward issue"
        self.facts: dict = {}
        self.batch_counts: list = []
        self.proc = self.server = None

    def _recv(self, what: str, timeout: float = _READY_TIMEOUT_S):
        if not self.conn.poll(timeout):
            raise RuntimeError(f"the clients' process sent no {what!r} in {timeout} s")
        msg = self.conn.recv()
        if msg[0] != what:
            raise RuntimeError(f"the clients' process sent {msg[0]!r}, not {what!r}")
        return msg

    def setup(self) -> None:
        from pamnet_tpu_torch import serve
        from pamnet_tpu_torch.config import PAMNetConfig

        cfg, t = self.cfg, self.cell["traffic"]
        t0 = time.monotonic()
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=score_clients.client_main, args=(child, t, self.seed),
                                daemon=True, name="bench-clients")
        self.proc.start()
        child.close()
        if self.traced:
            self._wrap_loader(serve)
        pcfg = PAMNetConfig(dataset="rna_serve", dim=cfg["dim"], n_layer=cfg["n_layer"],
                            cutoff_l=cfg["cutoff_l"], cutoff_g=cfg["cutoff_g"], flow=cfg["flow"],
                            compute_dtype=cfg["compute_dtype"])
        if pcfg.folds() != cfg["folded"]:
            raise RuntimeError(f"the program folds={pcfg.folds()}, the configuration "
                               f"states folded={cfg['folded']}")
        spec = ref_steps.model_of(cfg).param_spec(cfg)
        state = weights.seeded_state(spec, self.seed, self.device)
        self.service = serve.RNAScoringService(state, pcfg, batch_size=cfg["serve"]["batch_size"],
                                               ladder_pads=cfg["serve"]["ladder_pads"],
                                               device=self.device)
        del state
        self.server = serve.make_server(self.service, "127.0.0.1", 0,
                                        f"random weights, seed {self.seed}")
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True,
                                       name="bench-server")
        self.thread.start()
        t1 = time.monotonic()
        self.conn.send(("port", self.server.server_address[1]))
        statuses = self._recv("ready")[1]
        self.facts["setup_parts"] = {"service_s": t1 - t0, "clients_ready_s": time.monotonic() - t1}
        if any(s != 200 for s in statuses):
            raise RuntimeError(f"warm-up requests failed: statuses {statuses}")
        self.spans.clear()
        self.batch_counts.clear()

    def _wrap_loader(self, serve) -> None:
        """Time the host graph build and the collations of the service's
        ``GraphLoader`` as host spans, and keep each batch's valid counts."""
        base, spans, counts = serve.GraphLoader, self.spans, self.batch_counts

        class TimedLoader(base):
            def __init__(self, *a, **k):
                t0 = time.time_ns()
                super().__init__(*a, **k)
                spans.append(("host graph build", t0, time.time_ns()))

            def collate(self, *a, **k):
                t0 = time.time_ns()
                gb = super().collate(*a, **k)
                spans.append(("collation", t0, time.time_ns()))
                counts.append(dict(gb.valid))
                return gb

        serve.GraphLoader = TimedLoader

    def window(self, seconds: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0_ns, w0 = time.time_ns(), time.monotonic()
        self.window_start = w0
        self.conn.send(("go", w0, w0 + seconds))
        _, records = self._recv("done", seconds + 600)
        t1_ns = t0_ns + int(seconds * 1e9)
        self.t_ns = (t0_ns, t1_ns)
        end = w0 + seconds
        done = [r for r in records if r[2] <= end]
        ok = [r for r in done if r[3] == 200]
        self.received = {r[0]: r[4] for r in ok}
        sent = [r for r in records if r[1] <= end]
        self.facts.update(
            window_s=seconds, latencies_s=[r[2] - r[1] for r in done if r[3] == 200],
            scored=len(ok), attempted=len(sent), failed=sum(1 for r in records if r[3] != 200))
        if self.traced:
            self.facts["host_build_s"] = sum((b - a) / 1e9 for _, a, b in self.spans)

    def work(self, counts_module) -> dict:
        flops = sum(counts_module.forward_flops(self.cfg, c) for c in self.batch_counts)
        nbytes = sum(counts_module.mp_bytes(self.cfg, c) for c in self.batch_counts)
        return {"flops": flops, "mp_bytes": nbytes}

    def free(self) -> None:
        self.close_server()
        self.service = None

    def close_server(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.thread.join()
            self.server = None

    # ---- the check ----------------------------------------------------------
    def sample(self) -> list[int]:
        ids = sorted(self.received)
        rng = np.random.default_rng([self.seed, 7])
        k = min(self.cell["traffic"]["sample"], len(ids))
        return sorted(rng.choice(ids, size=k, replace=False).tolist()) if k else []

    def reference(self, precision: str = "float32", drop_half: bool = False) -> dict:
        from benchmark import check

        if not hasattr(self, "check_mols"):
            self.check_ids = self.sample()
            self.conn.send(("bodies", self.check_ids))
            gen = score_clients.generator(self.cell["traffic"])
            self.check_mols = [gen.parse_pdb(text) for text in self._recv("bodies")[1]]
        spec = ref_steps.model_of(self.cfg).param_spec(self.cfg)
        state = weights.seeded_state(spec, self.seed, self.device)
        with check.precision(precision) as quant:
            return {"scores": ref_steps.scores(state, self.check_mols, self.cfg, self.device,
                                               quant)}

    def compare(self, ref: dict) -> dict:
        from benchmark import check

        got = [self.received[k] for k in self.check_ids]
        return {"score_gap": check.score_gap(got, ref["scores"]) if got else float("inf")}

    def close(self) -> None:
        self.close_server()
        if self.proc is not None:
            if self.proc.is_alive():
                try:
                    self.conn.send(("stop",))
                except OSError:
                    pass
            self.proc.join(30)
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join(10)
            self.proc = None
