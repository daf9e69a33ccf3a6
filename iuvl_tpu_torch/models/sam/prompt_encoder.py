"""SAM prompt encoder, PyTorch port of ``iuvl_tpu/models/sam/prompt_encoder.py``.

Point/box/mask prompts -> sparse token embeddings (B, T, C) and a dense
NHWC map. Prompts are static-shape batches: points (B, N, 2) in pixel xy
with labels (B, N), label -1 marking padding; boxes (B, 4) xyxy. Without
boxes one not-a-point pad token is appended, as the reference does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.common import conv_nhwc, gelu
from .image_encoder import LayerNorm2d


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding. The gaussian matrix is a buffer
    (a bridged parameter: loaded, never drawn twice across packages)."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1], (..., 2) -> (..., 2 * num_pos_feats)."""
        c = 2.0 * coords.float() - 1.0
        c = (2.0 * math.pi) * (c @ self.positional_encoding_gaussian_matrix.float())
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, size: tuple[int, int]) -> torch.Tensor:
        """Dense PE for an (H, W) grid -> (H, W, C)."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        return self(torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1))


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: tuple[int, int] = (64, 64),
                 input_image_size: tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.dtype = dtype
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # neg point, pos point, box corner 1, box corner 2
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, 2), LayerNorm2d(mask_in_chans // 4),
            nn.GELU(), nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1))

    def get_dense_pe(self) -> torch.Tensor:
        """(H, W, C) positional map of the image embedding grid."""
        return self.pe_layer.grid(self.image_embedding_size)

    def _scaled(self, xy: torch.Tensor) -> torch.Tensor:
        """Pixel xy -> [0, 1] (per-axis python scalars: no host-to-device copy)."""
        h, w = self.input_image_size
        xy = xy.float() + 0.5
        return torch.stack((xy[..., 0] / w, xy[..., 1] / h), dim=-1)

    def _embed_points(self, points, labels):
        pe = self.pe_layer(self._scaled(points))
        lab = labels[..., None]
        out = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        out = torch.where(lab == 0, pe + self.point_embeddings[0].weight[0], out)
        return torch.where(lab == 1, pe + self.point_embeddings[1].weight[0], out)

    def _embed_boxes(self, boxes):
        pe = self.pe_layer(self._scaled(boxes.reshape(-1, 2, 2)))
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        return pe + corner

    def _embed_masks(self, masks):
        """masks (B, 4H, 4W, 1) -> dense (B, H, W, C)."""
        md, dt = self.mask_downscaling, self.dtype
        y = gelu(md[1](conv_nhwc(masks, md[0], dt)))
        y = gelu(md[4](conv_nhwc(y, md[3], dt)))
        return conv_nhwc(y, md[6], dt)

    def forward(self, points=None, labels=None, boxes=None, masks=None, batch=1):
        """Returns (sparse (B, T, C), dense (B or 1, H, W, C)) in the
        working dtype; the no-mask dense map stays batch-1."""
        parts = []
        if points is not None:
            if boxes is None:
                bs = points.shape[0]
                points = torch.cat([points, points.new_zeros(bs, 1, 2)], dim=1)
                labels = torch.cat([labels, -labels.new_ones(bs, 1)], dim=1)
            parts.append(self._embed_points(points, labels))
        if boxes is not None:
            parts.append(self._embed_boxes(boxes))
        if parts:
            sparse = torch.cat(parts, dim=1)
        else:
            sparse = torch.zeros(batch, 0, self.embed_dim,
                                 device=self.no_mask_embed.weight.device)
        if masks is not None:
            dense = self._embed_masks(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
                1, h, w, self.embed_dim)
        return sparse.to(self.dtype), dense.to(self.dtype)
