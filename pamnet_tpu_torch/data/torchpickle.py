"""Read PyG's preprocessed artifacts (``torch.save`` of a ``(Data, slices)``
pair: ``data_v2.pt`` / ``qm9_v2.pt``; reference: datasets/qm9_dataset.py:
156-160,170-185) without ``torch_geometric``: the read side of the JAX
package's ``pamnet_tpu/utils/torchpickle.py``.

``torch.load(..., weights_only=True)`` reads both on-disk formats, the zip
archive and the legacy stream, and rebuilds only tensors, containers and the
globals it is told are safe.  Each PyG class an artifact may name is mapped
to an attribute bag (``Record``) through ``torch.serialization.safe_globals``'
``(obj, "module.name")`` form, so no PyG code is imported and no global
outside that list and PyTorch's own allowlist can run: a file naming any
other global is refused with an error that names it.
"""

from __future__ import annotations

import pickle

import torch

# The classes a preprocessed QM9 artifact may name (PyG 1.x pickles Data with
# its tensors as attributes; PyG 2.x keeps them in a storage, ``_store``).
PYG_CLASSES = (
    "torch_geometric.data.data.Data",
    "torch_geometric.data.data.DataEdgeAttr",
    "torch_geometric.data.data.DataTensorAttr",
    "torch_geometric.data.storage.GlobalStorage",
)


class Record:
    """An attribute bag standing in for a PyG class: its pickled state read
    back as attributes.  A PyG 2.x ``Data`` holds its tensors in a storage
    (``_store``, whose own state holds ``_mapping``); an attribute that is not
    the record's own is looked up there."""

    _class_name = ""

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:  # (dict, slot state)
            for part in state:
                self.__dict__.update(part or {})
        elif isinstance(state, dict):
            self.__dict__.update(state)
        else:
            raise pickle.UnpicklingError(
                f"{self._class_name}: unexpected pickled state {type(state).__name__}")

    def __getattr__(self, name: str):
        for inner in ("_store", "_mapping"):
            held = self.__dict__.get(inner)
            if isinstance(held, dict) and name in held:
                return held[name]
            if isinstance(held, Record):
                try:
                    return getattr(held, name)
                except AttributeError:
                    pass
        raise AttributeError(f"{self._class_name or type(self).__name__} has no {name!r}")


def _records() -> list[tuple[type, str]]:
    return [(type(name.rsplit(".", 1)[1], (Record,), {"_class_name": name}), name)
            for name in PYG_CLASSES]


def load_torch_pickle(path: str):
    """The object of a ``torch.save`` file (zip or legacy) with tensors as
    CPU tensors and PyG classes as ``Record``s.  Raises
    ``pickle.UnpicklingError`` naming the first global that is neither a
    PyG class of ``PYG_CLASSES`` nor on PyTorch's weights-only allowlist."""
    with torch.serialization.safe_globals(_records()):
        try:
            return torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            raise pickle.UnpicklingError(f"{path}: refused: {e}") from None
