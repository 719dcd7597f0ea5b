"""Model zoo of the port: the dense decoder LM, built from configs."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderModel


def build_model(cfg: ModelConfig, device=None) -> DecoderModel:
    """The model of ``cfg``, uninitialised, on the card unless ``device`` says.

    The audio encoder-decoder is not ported yet: ``DecoderModel`` raises
    ``NotImplementedError`` for it.
    """
    return DecoderModel(cfg, device)


__all__ = ["DecoderModel", "ModelConfig", "build_model"]
