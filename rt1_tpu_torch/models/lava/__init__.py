"""The LAVA model family (counterpart of `rt1_tpu/models/lava/`).

Parity source: reference `language_table/train/networks/` — the
`SequenceLAVMSE` (language-conditioned cross-attention over a visual
feature pyramid + temporal transformer) and `PixelLangMSE` (conv-maxpool
with multiplicative language fusion) architectures, both regressing
continuous actions with MSE (`trainer/bc.py`).
"""

from rt1_tpu_torch.models.lava.blocks import (
    DenseResnet,
    PrenormEncoderLayer,
    PrenormPixelLangEncoder,
    TemporalTransformer,
    positional_encoding_2d,
)
from rt1_tpu_torch.models.lava.lava import SequenceLAVAEncoder, SequenceLAVMSE
from rt1_tpu_torch.models.lava.pixel import PixelLangMSE
from rt1_tpu_torch.models.lava.resnet import MultiscaleResNet

__all__ = [
    "DenseResnet",
    "PrenormEncoderLayer",
    "PrenormPixelLangEncoder",
    "TemporalTransformer",
    "positional_encoding_2d",
    "SequenceLAVAEncoder",
    "SequenceLAVMSE",
    "PixelLangMSE",
    "MultiscaleResNet",
]
