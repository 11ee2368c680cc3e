from sonicscribe_tpu_torch.models.config import (  # noqa: F401
    AudioEncoderConfig,
    DecoderConfig,
    GlmAsrConfig,
    nano,
    tiny,
)
