"""SequenceLAVA encoder + MSE policy head (counterpart of
`rt1_tpu/models/lava/lava.py`).

Parity source: reference `language_table/train/networks/lava.py:32-518`.
Image encoders: "conv_maxpool" (4x conv3x3 -> relu -> max-pool plus a
final max-pool: a five-level pyramid) and "resnet" (ImageNet-normalise,
bilinear resize to 224 without antialiasing, the frozen ResNet stem and
first stage, then a conv-maxpool tail). Language encoders:
"embedding_in_obs" (a precomputed embedding under `lang_key`) and "clip"
(the in-graph CLIP text tower over `instruction_tokenized_clip`, frame 0
of each window; its features are L2-normalised before the projection).
The language is the query of the cross-attention and the visual sentence
its key and value. Max-pools are VALID, so odd sizes floor (456 -> 228 ->
114 -> 57 -> 28 -> 14). Everything runs in float32; images are NHWC in
[0, 1] at the interface and NCHW inside.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rt1_tpu_torch.models.lava.blocks import (
    DenseResnet,
    LavaDense,
    PrenormPixelLangEncoder,
    TemporalTransformer,
    layer_norm,
    positional_encoding_2d,
)
from rt1_tpu_torch.models.lava.clip_text import CLIPTextEncoder
from rt1_tpu_torch.models.lava.resnet import MultiscaleResNet, SameConv2d
from rt1_tpu_torch.ops.dropout import Rngs, dropout

IMAGE_ENCODERS = ("conv_maxpool", "resnet")
LANG_ENCODERS = ("embedding_in_obs", "clip")
RESNET_SIZE = 224
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """`nn.max_pool((2, 2), strides=(2, 2), padding="VALID")`, NCHW."""
    return F.max_pool2d(x, 2, 2)


class ConvMaxpoolCNNEncoder(nn.Module):
    """4x (conv3x3 -> relu -> maxpool) + final maxpool => 5-level pyramid."""

    out_channels = (32, 64, 128, 256, 256)

    def __init__(self):
        super().__init__()
        in_ch = 3
        for i, features in enumerate((32, 64, 128, 256)):
            self.add_module(f"Conv_{i}", SameConv2d(in_ch, features, 3))
            in_ch = features

    def forward(self, rgb: torch.Tensor) -> List[torch.Tensor]:
        x, pyramid = rgb, []
        for i in range(4):
            x = _pool(F.relu(getattr(self, f"Conv_{i}")(x)))
            pyramid.append(x)
        pyramid.append(_pool(x))
        return pyramid


def normalize_image_resnet(images: torch.Tensor) -> torch.Tensor:
    """NHWC in [0, 1] -> ImageNet-normalised NCHW at 224x224, resized
    bilinearly with half-pixel centres and no antialiasing (reference
    `lava.py:90-98`; `jax.image.resize(..., "bilinear", antialias=False)`)."""
    mean = images.new_tensor(IMAGENET_MEAN)
    std = images.new_tensor(IMAGENET_STD)
    x = ((images - mean) / std).permute(0, 3, 1, 2)
    return F.interpolate(x, size=(RESNET_SIZE, RESNET_SIZE), mode="bilinear",
                         align_corners=False, antialias=False)


class ResNetVisualEncoder(nn.Module):
    """Frozen ResNet stem + first stage, a conv-maxpool tail => 5-level pyramid."""

    out_channels = (64, 256, 128, 256, 256)

    def __init__(self):
        super().__init__()
        self.MultiscaleResNet_0 = MultiscaleResNet(stage_sizes=(3, 4))
        self.Conv_0 = SameConv2d(256, 128, 3)
        self.Conv_1 = SameConv2d(128, 256, 3)

    def forward(self, rgb_nhwc: torch.Tensor) -> List[torch.Tensor]:
        features = self.MultiscaleResNet_0(normalize_image_resnet(rgb_nhwc), num_outputs=2)
        pyramid = [features[0], features[1]]
        x = features[1]
        for conv in (self.Conv_0, self.Conv_1):
            x = _pool(F.relu(conv(x)))
            pyramid.append(x)
        pyramid.append(_pool(x))
        return pyramid


class VisualDescriptorsNet(nn.Module):
    """Pyramid levels -> flattened, 2-D position-embedded 'visual sentence'."""

    def __init__(self, level_channels: Sequence[int], pyramid_fuse_layers: Sequence[int],
                 d_model: int):
        super().__init__()
        self.pyramid_fuse_layers = tuple(pyramid_fuse_layers)
        self.d_model = d_model
        for i, idx in enumerate(self.pyramid_fuse_layers):
            self.add_module(f"Dense_{i}", LavaDense(level_channels[idx], d_model))
        self._tables: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def _table(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, device)
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(positional_encoding_2d(self.d_model, h, w)).to(device)
        return self._tables[key]

    def forward(self, pyramid: Sequence[torch.Tensor]) -> torch.Tensor:
        pieces = []
        for i, idx in enumerate(self.pyramid_fuse_layers):
            x = pyramid[idx].permute(0, 2, 3, 1)  # NHWC
            b, h, w, _ = x.shape
            x = getattr(self, f"Dense_{i}")(x).reshape(b, h * w, self.d_model)
            x = x * math.sqrt(float(self.d_model))
            pieces.append(x + self._table(h, w, x.device))
        return torch.cat(pieces, dim=1)


class SequenceLAVAEncoder(nn.Module):
    """Pyramid -> visual sentence -> language cross-attn -> temporal pool."""

    def __init__(self, image_encoder: str, lang_encoder: str, num_layers: int = 2,
                 sequence_length: int = 4, temporal_transformer_num_layers: int = 2,
                 d_model: int = 128, num_heads: int = 2,
                 pyramid_fuse_layers: Tuple[int, ...] = (2, 3, 4),
                 lang_key: str = "natural_language_embedding",
                 text_encoder: Optional[nn.Module] = None, lang_dim: int = 512):
        super().__init__()
        if image_encoder not in IMAGE_ENCODERS:
            raise NotImplementedError(image_encoder)
        if lang_encoder not in LANG_ENCODERS:
            raise NotImplementedError(lang_encoder)
        self.image_encoder = image_encoder
        self.lang_encoder = lang_encoder
        self.num_layers = num_layers
        self.d_model = d_model
        self.lang_key = lang_key
        if image_encoder == "resnet":
            self.ResNetVisualEncoder_0 = ResNetVisualEncoder()
            channels = ResNetVisualEncoder.out_channels
        else:
            self.ConvMaxpoolCNNEncoder_0 = ConvMaxpoolCNNEncoder()
            channels = ConvMaxpoolCNNEncoder.out_channels
        self.VisualDescriptorsNet_0 = VisualDescriptorsNet(channels, pyramid_fuse_layers, d_model)
        if lang_encoder == "clip":
            # A stable name, so the freeze prefix and the pretrained remap
            # do not depend on auto-numbering.
            self.text_encoder = text_encoder if text_encoder is not None else CLIPTextEncoder()
            lang_dim = self.text_encoder.embed_dim
        self.Dense_0 = LavaDense(lang_dim, d_model)
        for i in range(num_layers):
            # Two heads, as the reference fixes them for the cross-attention.
            self.add_module(f"PrenormPixelLangEncoder_{i}",
                            PrenormPixelLangEncoder(d_model, d_model, num_heads=2, dff=d_model))
        self.LayerNorm_0 = layer_norm(d_model)
        self.TemporalTransformer_0 = TemporalTransformer(
            d_model, temporal_transformer_num_layers, d_model, num_heads, d_model,
            sequence_length)

    def forward(self, obs: Dict[str, torch.Tensor], train: bool = False,
                rngs: Rngs = None) -> torch.Tensor:
        rgb = obs["rgb"]
        bs, seqlen, h, w, c = rgb.shape
        rgb = rgb.reshape(bs * seqlen, h, w, c).to(self.Dense_0.weight.dtype)
        if self.image_encoder == "resnet":
            pyramid = self.ResNetVisualEncoder_0(rgb)
        else:
            pyramid = self.ConvMaxpoolCNNEncoder_0(rgb.permute(0, 3, 1, 2))
        visual_sentence = dropout(self.VisualDescriptorsNet_0(pyramid), 0.1, train, rngs)

        if self.lang_encoder == "embedding_in_obs":
            lang = obs[self.lang_key].reshape(bs * seqlen, -1).to(rgb.dtype)
        else:
            tokens = obs["instruction_tokenized_clip"][:, 0]
            lang = self.text_encoder(tokens)
            lang = lang[:, None, :].expand(-1, seqlen, -1).reshape(bs * seqlen, -1)
            lang = lang / torch.linalg.vector_norm(lang, dim=-1, keepdim=True)
        lang = self.Dense_0(lang) * math.sqrt(self.d_model)
        fused = dropout(lang, 0.1, train, rngs)[:, None, :]
        for i in range(self.num_layers):
            fused = getattr(self, f"PrenormPixelLangEncoder_{i}")(visual_sentence, fused, train,
                                                                 rngs)
        fused = self.LayerNorm_0(fused[:, 0])
        return self.TemporalTransformer_0(fused.reshape(bs, seqlen, -1), train, rngs)


class SequenceLAVMSE(nn.Module):
    """LAVA encoder -> DenseResnet -> action regression head."""

    def __init__(self, action_size: int, dense_resnet_width: int, dense_resnet_num_blocks: int,
                 lava_num_layers: int = 2, lava_sequence_length: int = 4,
                 lava_temporal_transformer_num_layers: int = 2, lava_d_model: int = 128,
                 lava_num_heads: int = 2, lava_pyramid_fuse_layers: Tuple[int, ...] = (2, 3, 4),
                 lava_image_encoder: str = "conv_maxpool",
                 lava_lang_encoder: str = "embedding_in_obs",
                 lang_key: str = "natural_language_embedding",
                 text_encoder: Optional[nn.Module] = None):
        super().__init__()
        self.sequence_length = lava_sequence_length
        self.lang_encoder = lava_lang_encoder
        self.encoder = SequenceLAVAEncoder(
            image_encoder=lava_image_encoder,
            lang_encoder=lava_lang_encoder,
            num_layers=lava_num_layers,
            sequence_length=lava_sequence_length,
            temporal_transformer_num_layers=lava_temporal_transformer_num_layers,
            d_model=lava_d_model,
            num_heads=lava_num_heads,
            pyramid_fuse_layers=lava_pyramid_fuse_layers,
            lang_key=lang_key,
            text_encoder=text_encoder,
        )
        self.dense_resnet = DenseResnet(lava_d_model, dense_resnet_width, dense_resnet_num_blocks)
        self.action_projection = LavaDense(dense_resnet_width, action_size)

    def forward(self, obs: Dict[str, torch.Tensor], train: bool = False,
                rngs: Rngs = None) -> torch.Tensor:
        return self.action_projection(self.dense_resnet(self.encoder(obs, train, rngs)))
