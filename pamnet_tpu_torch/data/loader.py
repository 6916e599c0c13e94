"""Batch loader: per-structure graph build (with the host basis unless the
batches derive it), then padded batches in order or shuffled per epoch (the
inference and training subset of ``pamnet_tpu.data.loader.GraphLoader``),
each collated through a ``CollatePlan`` over the loader's structures (the
native library's concatenations, as the JAX loader collates wherever its
library loads; here the library is required).  ``prefetch`` collates the
next batches in a background thread while the caller steps
(``background``).  Spans (``profiling.span``): ``loader.build``, a loader's
construction (the structures' build, ``data/structcache.py``'s
``build.graph`` and ``build.basis`` inside), and ``loader.collate``, the
collation of a batch that iteration or ``prefetch`` hands out (``ref``: the
batch's index under ``prefetch``, else the caller's span's)."""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

from pamnet_tpu_torch.config import atom_type_count, embeds_atom_types
from pamnet_tpu_torch.data import structcache
from pamnet_tpu_torch.data.batch import (
    CollatePlan,
    PadSizes,
    collate_structures,
    structure_counts,
)
from pamnet_tpu_torch.profiling import span


def background(items, depth: int = 2, name: str = "pamnet-background"):
    """Iterate ``items`` in a daemon thread (named ``name``, as the program's
    spans name their threads) that runs up to ``depth`` items
    ahead of the caller through a bounded queue (the worker of the JAX
    package's ``GraphLoader.prefetch`` and ``train/loop.py::_staged``).  An
    exception of the worker is raised again in the caller and ends the
    iteration there, so a truncated epoch never passes silently.  A caller
    that stops early (``close()``, or the generator dropped) stops the
    worker at its next item and joins it; the worker closes ``items``."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    closed = threading.Event()
    end = object()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker() -> None:
        try:
            for item in items:
                if not put((item, None)):
                    return
            put((end, None))
        except BaseException as e:  # noqa: BLE001 - raised again in the caller
            put((None, e))
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=worker, daemon=True, name=name)
    thread.start()
    try:
        while True:
            item, err = q.get()
            if err is not None:
                raise err
            if item is end:
                return
            yield item
    finally:
        closed.set()
        thread.join()


class GraphLoader:
    """Iterates padded ``GraphBatch``es over molecules.

    Args:
      mols: molecule dicts with ``z``, ``pos`` and ``y`` (QM9: also the bond
        ``edge_index``; PDBbind: ``feat`` in place of ``z``).
      dataset_kind: "qm9", "pdbbind" or "rna"; ``variant``: "full", or "s"
        (PAMNet_s: no triplets).
      pads: a minimum bucket (the caller's high-water pads); any dimension
        this set of molecules exceeds is widened.  None = the worst case of
        this set (sum of the ``batch_size`` largest counts per dimension).
      ladder_pads: True pads each batch to the geometric bucket of its own
        counts, "exact" to its own counts rounded up to ``align`` (JAX's
        ``ladder_pads="exact"``: a fixed set scored once, no bucket
        overshoot), either capped at ``self.pads``; False pads every batch
        to ``self.pads`` itself.
      shuffle, seed: a new molecule order every epoch, one permutation per
        epoch from ``np.random.default_rng(seed)``, as the JAX loader draws
        them (so batches hold the same molecules).
      drop_last: drop an epoch's last, partial batch.
      build_perms: batches carry the backward's CSR arrays (training).
      wire_geometry: "host" ships the host distances (and basis);
        "derive" ships positions and integer tables only, and the model
        derives the geometry on the device.  Derive implies
        ``precompute_basis=False``.
      precompute_basis: build the host f64 spherical basis
        (``attach_basis``); without it the model derives the basis from the
        host distances (JAX ``main_qm9.py --device_basis``).
      cache_dir: serve the structures from the on-disk structure cache
        there (``data/structcache.py``, the JAX package's format), building
        and writing the chunks it lacks; ``cache_built`` is then the number
        of chunks this loader built.  None builds every structure in
        process.
      cache_workers: processes that build missing chunks (0 or 1: in
        process).
    """

    def __init__(self, mols: list[dict], dataset_kind: str, cutoff_l: float,
                 cutoff_g: float, batch_size: int, pads: PadSizes | None = None,
                 ladder_pads: bool | str = False, align: int = 128,
                 num_spherical: int = 7, num_radial: int = 6,
                 envelope_exponent: int = 5, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, build_perms: bool = False,
                 variant: str = "full", wire_geometry: str = "host",
                 precompute_basis: bool = True, cache_dir: str | None = None,
                 cache_workers: int = 0):
        if not mols:
            raise ValueError("GraphLoader needs at least one molecule")
        if ladder_pads not in (False, True, "exact"):
            raise ValueError(f"ladder_pads must be False, True or 'exact', got {ladder_pads!r}")
        self.batch_size = batch_size
        self.ladder_pads = ladder_pads
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.build_perms = build_perms
        self.variant = variant
        if wire_geometry not in ("host", "derive"):
            raise ValueError(
                f"wire_geometry must be 'host'|'derive', got {wire_geometry!r}")
        self.wire_geometry = wire_geometry
        precompute_basis = precompute_basis and wire_geometry == "host"
        self._num_atom_types = (atom_type_count(dataset_kind)
                                if embeds_atom_types(dataset_kind) else None)
        self._rng = np.random.default_rng(seed)
        self._align = align
        spec = structcache.BuildSpec(dataset_kind, cutoff_l, cutoff_g, variant,
                                     precompute_basis, num_spherical, num_radial,
                                     envelope_exponent)
        self.cache_built = None
        with span("loader.build"):
            if cache_dir is not None:
                # Cold builds at scale take minutes: show their progress.
                self.structs = structcache.load_or_build(mols, spec, cache_dir,
                                                         num_workers=cache_workers,
                                                         progress=len(mols) >= 10_000)
                self.cache_built = structcache.load_or_build.built
            else:
                self.structs = structcache.build_structures(mols, spec)
            self._counts = np.array([structure_counts(s) for s in self.structs])
        b = min(batch_size, len(self.structs))
        n, eg, el, t2, t1 = np.sort(self._counts, axis=0)[-b:].sum(axis=0)
        own = PadSizes.for_counts(int(n), max(int(eg), 1), max(int(el), 1),
                                  max(int(t2), 1), max(int(t1), 1), batch_size,
                                  align=align)
        self.pads = own if pads is None else own.widened(pads)
        self._plan: CollatePlan | None = None
        self._plan_lock = threading.Lock()

    def plan(self) -> CollatePlan:
        """The collate plan over the loader's structures, built at the first
        batch (by whichever thread collates it first); raises where the
        native library cannot be built."""
        with self._plan_lock:
            if self._plan is None:
                self._plan = CollatePlan(self.structs)
            return self._plan

    def __len__(self) -> int:
        n = len(self.structs)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def num_molecules(self) -> int:
        return len(self.structs)

    def rng_state(self) -> dict:
        """The shuffling generator's state (plain numbers and strings), for a
        checkpoint; ``set_rng_state`` continues the epochs' orders from it."""
        return self._rng.bit_generator.state

    def set_rng_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state

    def batches(self) -> list[list[int]]:
        """Molecule indices of each batch of the next epoch (draws this
        epoch's permutation when shuffling)."""
        order = np.arange(len(self.structs))
        if self.shuffle:
            order = self._rng.permutation(order)
        out = []
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            out.append(chunk.tolist())
        return out

    def _batch_pads(self, idxs: list[int]) -> PadSizes:
        n, eg, el, t2, t1 = self._counts[idxs].sum(axis=0)
        pad = PadSizes.for_counts if self.ladder_pads == "exact" else PadSizes.bucketed
        b = pad(int(n), max(int(eg), 1), max(int(el), 1), max(int(t2), 1), max(int(t1), 1),
                len(idxs), align=self._align)
        return PadSizes(*(min(getattr(b, f.name), getattr(self.pads, f.name))
                          for f in dataclasses.fields(PadSizes)))

    def collate(self, idxs: list[int], build_perms: bool | None = None):
        """The padded batch of the molecules ``idxs`` (``build_perms``: None
        takes the loader's), collated through the plan."""
        pads = self._batch_pads(idxs) if self.ladder_pads else self.pads
        build_perms = self.build_perms if build_perms is None else build_perms
        return collate_structures(None, pads, build_perms=build_perms,
                                  num_atom_types=self._num_atom_types,
                                  variant=self.variant, wire_geometry=self.wire_geometry,
                                  plan=self.plan(), idxs=idxs)

    def _collated(self, idxs: list[int], ref=None):
        """``collate(idxs)`` as the span ``loader.collate``."""
        with span("loader.collate", ref):
            return self.collate(idxs)

    def __iter__(self):
        for idxs in self.batches():
            yield self._collated(idxs)

    def prefetch(self, depth: int = 2, order: list[list[int]] | None = None):
        """The batches of ``order`` (None: the next epoch's, its permutation
        drawn now, as ``batches()`` draws it) collated in a background
        thread ``depth`` batches ahead of the caller (JAX
        ``GraphLoader.prefetch``, ``pamnet_tpu/data/loader.py:465-490``):
        bit for bit the batches of plain iteration.  The collation's native
        concatenations run without the GIL, so they overlap the caller's
        step; an error of the thread is raised in the caller."""
        order = self.batches() if order is None else order
        return background((self._collated(idxs, k) for k, idxs in enumerate(order)), depth,
                          "pamnet-prefetch")


def add_geometry_flags(parser) -> None:
    """The geometry flags of the JAX package's training entry points, with
    their defaults."""
    parser.add_argument("--host_geometry", action="store_true",
                        help="Ship host-computed float geometry (distances and the "
                             "f64 spherical basis) in training batches instead of the "
                             "default derive batches (positions and integer tables; "
                             "the geometry computed on the device in the step)")
    parser.add_argument("--device_basis", action="store_true",
                        help="Evaluation batches skip the host spherical basis too: "
                             "the model computes it on the device from the distances")


def add_cache_flags(parser, workers: bool = False) -> None:
    """The JAX training entry points' structure-cache flags, with their
    defaults (``--cache_workers`` on ``main_qm9`` only, as in JAX)."""
    parser.add_argument("--structure_cache", type=str, default="",
                        help="Directory for the on-disk precomputed-structure cache "
                             "(content-addressed, resumable; data/structcache.py)")
    if workers:
        parser.add_argument("--cache_workers", type=int, default=0,
                            help="Process-pool size for building missing "
                                 "structure-cache chunks (0 = in-process)")


def cache_options(args) -> dict:
    """``GraphLoader`` keyword arguments of the structure-cache flags, for
    every loader of a driver (train, val and test)."""
    return dict(cache_dir=args.structure_cache or None,
                cache_workers=getattr(args, "cache_workers", 0))


def build_note(seconds: float, loaders) -> str:
    """The drivers' note on their loaders' construction: its seconds and,
    where the loaders read the structure cache, the chunks they built."""
    built = [ld.cache_built for ld in loaders if ld.cache_built is not None]
    cache = f", {sum(built)} structure-cache chunks built" if built else ""
    return f"({seconds:.1f}s structure build{cache})"


def geometry_options(args) -> tuple[dict, dict]:
    """(training, evaluation) ``GraphLoader`` keyword arguments of the
    geometry flags: training batches derive unless ``--host_geometry``;
    ``--device_basis`` skips the host basis everywhere."""
    basis = dict(precompute_basis=not args.device_basis)
    return ({"wire_geometry": "host" if args.host_geometry else "derive", **basis}, basis)
