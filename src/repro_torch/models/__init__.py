"""Dense LM of the port."""

from repro_torch.models.registry import ModelAPI, get_model

__all__ = ["ModelAPI", "get_model"]
