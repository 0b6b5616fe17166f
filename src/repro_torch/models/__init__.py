from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import LanguageModel, build_model

__all__ = ["LanguageModel", "build_model", "params_from_jax"]
