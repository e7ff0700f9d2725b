"""Non-local 3D, the space-time non-local method (JAX counterpart:
models/nonlocal3d.py; reference models/non_local_models.py:9-112).

Every clip frame goes through the encoder; each C5 is embedded to 256
channels by a 1x1 conv, the embeddings are stacked on a time axis and run
through a space-time ``NLBlockND`` in ``dot`` mode, concatenated with the
per-frame embedding and classified by a 1x1 conv.  Every frame is
predicted: training averages the per-frame losses, and the eval CLI's
``test_all`` averages each frame's probabilities over the windows that
hold it (test_clip.py).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.masked import feature_valid, mask_valid, masked_trunk
from .layers import Conv
from .nonlocal_blocks import NLBlockND
from .resnet import build_encoder
from .segmentation import pixel_accuracy, upsampled_logprob_loss_projected


class NonLocal3D(nn.Module):
    def __init__(self, encoder: nn.Module, num_class: int, fc_dim: int = 2048):
        super().__init__()
        self.encoder = encoder
        self.emb = Conv(fc_dim, 256, 1)
        self.nonlocalblock = NLBlockND(256, mode="dot", dimension=3)
        self.last_layer = Conv(512, num_class, 1)

    def forward(self, imgs: torch.Tensor, valid_hw=None) -> torch.Tensor:
        """imgs [T, B, 3, H, W], every frame supervised → logits [T, B, K,
        h, w].

        ``valid_hw``: the true (rows, cols) of the frames inside the
        zero-padded width bucket ``imgs`` (eval only, under inference mode):
        the trunk runs under the spatial-conv-input mask, the embedding's
        band is re-zeroed in place (B6), and the space-time attention
        excludes the padded keys of every frame, so the valid region is the
        unpadded run's."""
        t, b = imgs.shape[:2]
        flat = imgs.flatten(0, 1)
        fv = None
        if valid_hw is None:
            emb = self.emb(self.encoder(flat)[-1])
        else:
            pad_hw = imgs.shape[-2:]
            with masked_trunk(self.encoder, valid_hw, pad_hw):
                c5 = self.encoder(flat)[-1]
            emb = self.emb(c5)
            fv = feature_valid(*emb.shape[-2:], valid_hw, pad_hw)
            emb = mask_valid(emb, fv)
        fh, fw = emb.shape[-2:]
        # [B, C, T, h, w]: time as a spatial dim of the block
        x = emb.reshape(t, b, 256, fh, fw).permute(1, 2, 0, 3, 4).contiguous()
        x = self.nonlocalblock(x, valid_hw=fv)
        x = x.permute(2, 0, 1, 3, 4).reshape(t * b, 256, fh, fw)
        x = self.last_layer(torch.cat([emb, x], dim=1))
        return x.reshape(t, b, -1, fh, fw)


def nonlocal3d_loss(outs, batch, **_):
    """The mean over frames of each frame's loss and accuracy (reference
    non_local_models.py:50-62): log_softmax, bilinear upsample and NLL in
    its projected form (models/segmentation.py).  ``batch["labels"]``: [T,
    B, H, W], 255 = ignore."""
    labels = batch["labels"]
    t = labels.shape[0]
    losses = [upsampled_logprob_loss_projected(outs[f], labels[f])
              for f in range(t)]
    accs = [pixel_accuracy(outs[f], labels[f]) for f in range(t)]
    return sum(losses) / t, sum(accs) / t


def build_nonlocal3d(cfg, num_class: int) -> NonLocal3D:
    return NonLocal3D(build_encoder(cfg.MODEL.arch_encoder), num_class,
                      fc_dim=cfg.MODEL.fc_dim)
