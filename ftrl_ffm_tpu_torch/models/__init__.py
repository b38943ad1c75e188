from ftrl_ffm_tpu_torch.models.base import Batch, Model, ModelState
from ftrl_ffm_tpu_torch.models.ffm import FFM
from ftrl_ffm_tpu_torch.models.fm import FM
from ftrl_ffm_tpu_torch.models.lr import LR


def make_model(cfg) -> Model:
    """Model factory (reference: src/task/ftrl_online.cpp:16-26)."""
    if cfg.model_type == "LR":
        return LR(cfg)
    if cfg.model_type == "FM":
        return FM(cfg)
    if cfg.model_type == "FFM":
        return FFM(cfg)
    raise ValueError(
        f"Invalid model_type: {cfg.model_type}, expect `LR`, `FM` or `FFM`."
    )


__all__ = ["Batch", "Model", "ModelState", "LR", "FM", "FFM", "make_model"]
