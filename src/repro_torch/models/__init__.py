from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import EncDecModel, LanguageModel, build_model

__all__ = ["EncDecModel", "LanguageModel", "build_model", "params_from_jax"]
