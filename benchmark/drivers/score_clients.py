"""The closed-loop clients of the score cells, in a process of their own so
their Python does not share the service's interpreter lock.  Imports
numpy and the benchmark's generator only.

Request k's body is the PDB text of ``gen/rna.py::derived(bases, seed, k,
stream=0)``, a pure function of the seed and k.  ``prebuild`` bodies are
built before the child reports ready; a builder thread then keeps
``prebuild`` bodies ahead of the clients, so no run can exhaust them and
no client waits on one.

Protocol over a ``multiprocessing`` pipe (the parent sends, the child
answers):
  ("port", port)        -> the child sends its warm-up requests (stream 1)
                           to http://127.0.0.1:<port>/score and answers
                           ("ready", warm-up statuses)
  ("go", t0, t_end)     -> ``clients`` threads post bodies 0, 1, ... in
                           turn, each sending its next one when the last
                           one's reply has come, none after ``t_end``
                           (``time.monotonic``); answers ("done", records)
                           with one (index, sent, done, status, score) each
  ("bodies", indices)   -> ("bodies", [PDB text of each])
  ("stop",)             -> the child ends
"""

from __future__ import annotations

import http.client
import importlib
import json
import threading
import time


def _post(port: int, body: bytes, name: str, timeout: float) -> tuple[int, float | None]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", f"/score?name={name}", body,
                     {"Content-Type": "chemical/x-pdb"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    score = json.loads(data)["scores"][0] if resp.status == 200 else None
    return resp.status, score


def generator(traffic: dict):
    """The traffic's generator, ``gen/<generator>.py`` (``bases``,
    ``derived``, ``pdb_text``, ``parse_pdb``)."""
    return importlib.import_module(f"benchmark.gen.{traffic['generator']}")


class Bodies:
    """Request bodies built in order by a thread that stays ``ahead`` of the
    highest body asked for."""

    def __init__(self, gen, bases: list, seed: int, ahead: int):
        self.gen, self.bases, self.seed, self.ahead = gen, bases, seed, ahead
        self.built: dict[int, bytes] = {}
        self.asked, self.next = -1, 0
        self.cond = threading.Condition()
        self.stopped = False
        for _ in range(ahead):
            self._build_next()
        self.thread = threading.Thread(target=self._run, daemon=True, name="bench-bodies")
        self.thread.start()

    def text(self, k: int) -> str:
        return self.gen.pdb_text(self.gen.derived(self.bases, self.seed, k, stream=0))

    def _build_next(self) -> None:
        body = self.text(self.next).encode()
        with self.cond:
            self.built[self.next] = body
            self.next += 1
            self.cond.notify_all()

    def _run(self) -> None:
        while True:
            with self.cond:
                while not self.stopped and self.next > self.asked + self.ahead:
                    self.cond.wait()
                if self.stopped:
                    return
            self._build_next()

    def take(self, k: int) -> bytes:
        with self.cond:
            self.asked = max(self.asked, k)
            self.cond.notify_all()
            while k not in self.built:
                self.cond.wait()
            return self.built.pop(k)

    def stop(self) -> None:
        with self.cond:
            self.stopped = True
            self.cond.notify_all()
        self.thread.join()


def client_main(conn, traffic: dict, seed: int) -> None:
    gen = generator(traffic)
    bases = gen.bases(traffic["base_seed"], traffic["bases"], traffic["n_atoms"])
    warm = [gen.pdb_text(gen.derived(bases, seed, k, stream=1)).encode()
            for k in range(traffic["warmup_requests"])]
    bodies = Bodies(gen, bases, seed, traffic["prebuild"])
    timeout = traffic["request_timeout_s"]
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "port":
                port = msg[1]
                statuses = [_post(port, body, f"warm{k}", timeout)[0]
                            for k, body in enumerate(warm)]
                conn.send(("ready", statuses))
            elif msg[0] == "go":
                _, _, t_end = msg
                records, lock, nxt = [], threading.Lock(), [0]

                def client() -> None:
                    while time.monotonic() < t_end:
                        with lock:
                            k = nxt[0]
                            nxt[0] += 1
                        body = bodies.take(k)
                        sent = time.monotonic()
                        try:
                            status, score = _post(port, body, f"r{k}", timeout)
                        except (OSError, http.client.HTTPException, ValueError):
                            status, score = 0, None
                        with lock:
                            records.append((k, sent, time.monotonic(), status, score))

                threads = [threading.Thread(target=client, daemon=True)
                           for _ in range(traffic["clients"])]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                conn.send(("done", records))
            elif msg[0] == "bodies":
                conn.send(("bodies", [bodies.text(k) for k in msg[1]]))
            else:
                return
    finally:
        bodies.stop()
