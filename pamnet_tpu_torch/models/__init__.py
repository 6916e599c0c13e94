"""PAMNet model of the port."""

from pamnet_tpu_torch.models.pamnet import PAMNet

__all__ = ["PAMNet"]
