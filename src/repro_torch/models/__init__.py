"""Model zoo of the port: the decoder LM (attention, Mamba, RWKV6, MoE), built from configs."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderModel


def build_model(cfg: ModelConfig, device=None) -> DecoderModel:
    """The model of ``cfg``, uninitialised, on the card unless ``device`` says.

    The audio encoder-decoder and the VLM front end are not ported yet:
    ``DecoderModel`` raises ``NotImplementedError`` for them.
    """
    return DecoderModel(cfg, device)


__all__ = ["DecoderModel", "ModelConfig", "build_model"]
