from ftrl_ffm_tpu_torch.config import not_ported
from ftrl_ffm_tpu_torch.models.base import Batch, Model, ModelState
from ftrl_ffm_tpu_torch.models.ffm import FFM


def make_model(cfg) -> Model:
    """Model factory (reference: src/task/ftrl_online.cpp:16-26).  The port
    trains and serves FFM; LR and FM arrive with a later slice."""
    if cfg.model_type == "FFM":
        return FFM(cfg)
    if cfg.model_type in ("LR", "FM"):
        raise not_ported(f"model_type={cfg.model_type}", 4)
    raise ValueError(
        f"Invalid model_type: {cfg.model_type}, expect `LR`, `FM` or `FFM`."
    )


__all__ = ["Batch", "Model", "ModelState", "FFM", "make_model"]
