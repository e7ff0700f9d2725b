"""TDNet (td4_psp), temporally distributed segmentation (JAX counterpart:
models/td4_psp.py; reference models/td4_psp/td4_psp.py, transformer.py,
loss.py).

Four ResNet-18-dilated paths each see a different frame of a 4-frame clip;
each path's channel-sliced PSP head, its q/k/v encoding (the context frames
subsampled by stride 3), a chain of cross-frame scaled dot-product
attentions, a spatial LayerNorm and FCN heads.  ``pos_id`` says which path
owns the target frame: the trainer rotates it, ``(step + 1) % 4``, and the
stream takes ``frame % 4``.

Streaming keeps the last three frames' K/V/Q tokens (``init_td4_state``, a
carry threaded by the caller), and a frame's attention runs once three
frames are in it.  The spatial LayerNorm's affine maps have the train
crop's feature size, ``int(cropsize / 8) + 1``; at another size they are
resized bilinearly.  Upsampling the logits is ``align_corners=True`` here,
in the loss and in eval, unlike every other method.

Parameter names are the reference's (``pretrained1..4``, ``psp1..4``,
``enc1..4``, ``atn{a}_{b}``, ``layer_norm1..4``, ``head1..4``,
``auxlayer1..4``), which the JAX package's ``import_td4_state_dict`` reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interpolate import resize_bilinear
from ..ops.masked import (adaptive_avg_pool2d_rt, ceil_div, feature_valid,
                          mask_valid, masked_trunk, resize_bilinear_rt)
from ..utils.metrics import pixel_acc
from .layers import BatchNorm2d, Conv, Dropout, Dropout2d
from .resnet import build_encoder

D_K, D_V = 64, 512


class ConvBN(nn.Module):
    """transformer.ConvBNReLU: a 1x1 conv and, with ``use_bn``, a BatchNorm;
    despite the reference's name, no activation."""

    def __init__(self, cin: int, cout: int, use_bn: bool = True):
        super().__init__()
        self.conv = Conv(cin, cout, 1)
        self.bn = BatchNorm2d(cout) if use_bn else None

    def forward(self, x):
        x = self.conv(x)
        return x if self.bn is None else self.bn(x)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[N, C, h, w] → [N, h*w, C], row-major positions."""
    return x.flatten(2).transpose(1, 2)


class Encoding(nn.Module):
    """q/k/v projections (reference transformer.py:9-57)."""

    def __init__(self, d_model: int = 512, d_k: int = D_K, d_v: int = D_V):
        super().__init__()
        self.w_qs = nn.Sequential(ConvBN(d_model, d_k),
                                  ConvBN(d_k, d_k, use_bn=False))
        self.w_ks = nn.Sequential(ConvBN(d_model, d_k),
                                  ConvBN(d_k, d_k, use_bn=False))
        self.w_vs = nn.Sequential(ConvBN(d_model, d_v, use_bn=False))

    def forward(self, fea, pre: bool = False, start: bool = False):
        """``pre``: the stride-3 subsample's (k, v, q) tokens, q None with
        ``start``; else (v [N, d_v, h, w], q tokens [N, h*w, d_k])."""
        if pre:
            fea = fea[:, :, ::3, ::3]
            k, v = _tokens(self.w_ks(fea)), _tokens(self.w_vs(fea))
            return k, v, None if start else _tokens(self.w_qs(fea))
        return self.w_vs(fea), _tokens(self.w_qs(fea))


class Attention(nn.Module):
    """Scaled dot-product attention and a 1x1 ``fc`` (reference
    transformer.py:71-105); both dropouts obey the port's override."""

    def __init__(self, d_v: int = D_V, d_k: int = D_K):
        super().__init__()
        self.temp = float(d_k) ** 0.5
        self.fc = nn.Sequential(ConvBN(d_v, d_v, use_bn=False))
        self.attn_drop = Dropout(0.1)
        self.out_drop = Dropout(0.1)

    def forward(self, k_src, v_src, q_tgt, fea_size=None, src_valid=None):
        """k_src [N, Q, d_k], v_src [N, Q, d_v], q_tgt [N, P, d_k] → [N, P,
        d_v], or [N, d_v, h, w] for ``fea_size`` (n, h, w).  ``src_valid``
        [Q] bool excludes padded source tokens from the softmax (width-
        bucketed eval)."""
        attn = torch.matmul(q_tgt.float(), k_src.float().transpose(1, 2)) \
            / self.temp
        if src_valid is not None:
            attn = attn.masked_fill(~src_valid, float("-inf"))
        attn = self.attn_drop(torch.softmax(attn, dim=2))
        out = torch.matmul(attn, v_src.float()).to(q_tgt.dtype)
        fc = self.fc[0].conv
        out = self.out_drop(F.linear(out, fc.weight.flatten(1), fc.bias))
        if fea_size is None:
            return out
        n, h, w = fea_size
        return out.transpose(1, 2).reshape(n, -1, h, w).contiguous()


class PyramidPoolingSliced(nn.Module):
    """Channel-sliced PSP (reference td4_psp.py:623-669): the full pyramid,
    then this path's channel slice of the input and of each branch."""

    SCALES = (1, 2, 3, 6)

    def __init__(self, in_channels: int, path_num: int, pid: int):
        super().__init__()
        out_ch = in_channels // 4
        self.path_num, self.pid = path_num, pid
        for i in range(4):
            self.add_module(f"conv{i + 1}", nn.Sequential(
                Conv(in_channels, out_ch, 1, bias=False), BatchNorm2d(out_ch),
                nn.ReLU(inplace=True)))

    def forward(self, x, valid=None):
        """``valid``: the valid (rows, cols) of a zero-masked padded ``x``:
        the pools cover the valid region and the resizes use the true sizes
        (ops/masked.py), so the output keeps a zero band."""
        n, c, h, w = x.shape
        feats = []
        for i, s in enumerate(self.SCALES):
            conv = getattr(self, f"conv{i + 1}")
            if valid is None:
                p = conv(F.adaptive_avg_pool2d(x, s))
                feats.append(resize_bilinear(p, (h, w), align_corners=True))
            else:
                p = conv(adaptive_avg_pool2d_rt(x, s, valid))
                feats.append(resize_bilinear_rt(p, (h, w), (s, s), valid,
                                                align_corners=True))
        sl, sl4 = c // self.path_num, c // (self.path_num * 4)
        a = self.pid
        return torch.cat([x[:, a * sl:(a + 1) * sl]]
                         + [f[:, a * sl4:(a + 1) * sl4] for f in feats], dim=1)


class FCNHead(nn.Module):
    def __init__(self, in_channels: int, num_class: int, chn_down: int = 4):
        super().__init__()
        inter = in_channels // chn_down
        self.conv5 = nn.Sequential(
            Conv(in_channels, inter, 3, padding=1, bias=False),
            BatchNorm2d(inter), nn.ReLU(inplace=True), Dropout2d(0.1),
            Conv(inter, num_class, 1))

    def forward(self, x):
        return self.conv5(x)


class SpatialLayerNorm(nn.Module):
    """``nn.LayerNorm([h, w])`` over NCHW: each channel's map normalised,
    eps 1e-5 (reference td4_psp.py:743-751).  The affine maps have the
    train crop's feature size and are resized bilinearly at another size."""

    def __init__(self, hw: int):
        super().__init__()
        self.ln = nn.LayerNorm((hw, hw))

    def forward(self, x, valid=None):
        """``valid``: width-bucketed eval; the statistics cover the valid
        region, the affine maps are resized to it on the padded grid, zero
        beyond (ops/masked.py), and ``x``'s band is re-zeroed in place."""
        shape = tuple(self.ln.normalized_shape)
        h, w = x.shape[-2:]
        scale, bias = self.ln.weight, self.ln.bias
        xf = x.float()
        if valid is not None:
            area = float(valid[0] * valid[1])
            mean = mask_valid(xf, valid).sum(dim=(2, 3), keepdim=True) / area
            dev = mask_valid(xf - mean, valid)
            var = (dev * dev).sum(dim=(2, 3), keepdim=True) / area
            scale, bias = (resize_bilinear_rt(m[None, None], (h, w), shape,
                                              valid)[0, 0]
                           for m in (scale, bias))
        else:
            mean = xf.mean(dim=(2, 3), keepdim=True)
            var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
            if (h, w) != shape:
                scale, bias = (resize_bilinear(m[None, None], (h, w))[0, 0]
                               for m in (scale, bias))
        xhat = (xf - mean) * torch.rsqrt(var + 1e-5)
        return (xhat * scale + bias).to(x.dtype)


def init_td4_state(batch: int, tokens: int, device=None, d_k: int = D_K,
                   d_v: int = D_V) -> dict:
    """The stream's carry: the last three frames' K, V, Q tokens (oldest
    first) and how many frames it holds (0 to 3)."""
    def z(d):
        return [torch.zeros(batch, tokens, d, device=device)
                for _ in range(3)]
    return {"K": z(d_k), "V": z(d_v), "Q": z(d_k), "count": 0}


def token_valid(th: int, tw: int, valid, device) -> torch.Tensor:
    """[th*tw] bool: the tokens of the stride-3 grid over a map whose valid
    (rows, cols) is ``valid``."""
    keep = torch.zeros(th, tw, dtype=torch.bool, device=device)
    keep[:ceil_div(valid[0], 3), :ceil_div(valid[1], 3)] = True
    return keep.reshape(-1)


class TD4PSP(nn.Module):
    def __init__(self, num_class: int, cropsize: int = 479):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"pretrained{i}", build_encoder("resnet18dilated"))
            self.add_module(f"psp{i}",
                            PyramidPoolingSliced(512, 2, (i - 1) % 2))
            self.add_module(f"enc{i}", Encoding())
        for a in range(1, 5):
            for b in range(1, 5):
                if a != b:
                    self.add_module(f"atn{a}_{b}", Attention())
        ln_hw = int(cropsize / 8) + 1
        for i in range(1, 5):
            self.add_module(f"layer_norm{i}", SpatialLayerNorm(ln_hw))
            self.add_module(f"head{i}", FCNHead(512, num_class))
            self.add_module(f"auxlayer{i}", FCNHead(256, num_class))

    def part(self, kind: str, p: int) -> nn.Module:
        """Path p's (0-3) module of ``kind`` (pretrained, psp, enc,
        layer_norm, head, auxlayer)."""
        return getattr(self, f"{kind}{p + 1}")

    def atn(self, p: int, j: int) -> Attention:
        """Path p's attention reading source encoding j."""
        return getattr(self, f"atn{p + 1}_{j + 1}")

    def forward(self, imgs, pos_id: int = 0):
        """imgs [4, B, 3, H, W] in temporal order, the target last →
        (main, sub, aux) logits of the target at feature size; path
        ``pos_id`` owns the target (reference forward_path*)."""
        if imgs.shape[0] != 4:
            raise ValueError(f"TDNet takes 4-frame clips, got {imgs.shape[0]}")
        p = pos_id
        zs, c3_target = {}, None
        for i in range(4):            # frames 0-2 the context, 3 the target
            e = (p + i + 1) % 4 if i < 3 else p
            conv_out = self.part("pretrained", e)(imgs[i])
            zs[e] = self.part("psp", e)(conv_out[-1])
            if i == 3:
                c3_target = conv_out[-2]
        ctx = [(p + 1) % 4, (p + 2) % 4, (p + 3) % 4]
        k0, v0, _ = self.part("enc", ctx[0])(zs[ctx[0]], pre=True, start=True)
        k1, v1, q1 = self.part("enc", ctx[1])(zs[ctx[1]], pre=True)
        k2, v2, q2 = self.part("enc", ctx[2])(zs[ctx[2]], pre=True)
        v_t, q_t = self.part("enc", p)(zs[p])
        n, _, fh, fw = v_t.shape
        a1 = self.atn(p, ctx[0])(k0, v0, q1)
        a2 = self.atn(p, ctx[1])(k1, a1 + v1, q2)
        atn = self.atn(p, ctx[2])(k2, a2 + v2, q_t, fea_size=(n, fh, fw))
        head, ln = self.part("head", p), self.part("layer_norm", p)
        return (head(ln(atn + v_t)), head(ln(v_t)),
                self.part("auxlayer", p)(c3_target))

    def stream(self, img, pos_id: int, state: dict, valid_hw=None):
        """One frame img [B, 3, H, W] through path ``pos_id`` with the carry
        ``state`` (:func:`init_td4_state`) → (logits [B, K, h, w], the next
        carry).  Eval only, under inference mode.

        ``valid_hw``: the true size inside the zero-padded width bucket
        ``img``: the trunk under the spatial-conv-input mask, C5 and the
        attended features re-zeroed (B6), the sliced PSP and the LayerNorm
        on their masked paths, and padded tokens excluded from each
        attention's softmax (the carry lives on the padded token grid; its
        padded tokens are garbage that every reader masks out)."""
        p = pos_id
        path = self.part("pretrained", p)
        fv = tok = None
        if valid_hw is not None:
            pad_hw = img.shape[-2:]
            with masked_trunk(path, valid_hw, pad_hw):
                c5 = path(img)[-1]
            fv = feature_valid(*c5.shape[-2:], valid_hw, pad_hw)
            c5 = mask_valid(c5, fv)
            z = self.part("psp", p)(c5, valid=fv)
            tok = token_valid(ceil_div(c5.shape[2], 3),
                              ceil_div(c5.shape[3], 3), fv, img.device)
        else:
            z = self.part("psp", p)(path(img)[-1])
        enc = self.part("enc", p)
        v_cur, q_cur = enc(z)
        feat = v_cur
        if state["count"] >= 3:
            n, _, fh, fw = v_cur.shape
            ctx = [(p + 1) % 4, (p + 2) % 4, (p + 3) % 4]
            k, v, q = state["K"], state["V"], state["Q"]
            a1 = self.atn(p, ctx[0])(k[0], v[0], q[1], src_valid=tok)
            a2 = self.atn(p, ctx[1])(k[1], a1 + v[1], q[2], src_valid=tok)
            feat = self.atn(p, ctx[2])(k[2], a2 + v[2], q_cur,
                                       fea_size=(n, fh, fw),
                                       src_valid=tok) + v_cur
        ln = self.part("layer_norm", p)
        if fv is not None:
            feat = ln(mask_valid(feat, fv), valid=fv)
        else:
            feat = ln(feat)
        out = self.part("head", p)(feat)
        k_new, v_new, q_new = enc(z, pre=True)
        new_state = {"K": state["K"][1:] + [k_new.float()],
                     "V": state["V"][1:] + [v_new.float()],
                     "Q": state["Q"][1:] + [q_new.float()],
                     "count": min(state["count"] + 1, 3)}
        return out, new_state


def ohem_ce_loss(logits_up: torch.Tensor, label: torch.Tensor, n_min: int,
                 thresh: float = 0.7, ignore_index: int = 255):
    """OHEM cross-entropy (reference td4_psp/loss.py:21-44): the per-pixel
    CE sorted descending, ignored pixels counting 0; if the ``n_min``-th
    exceeds -log(thresh), the mean of all losses above it, else the mean of
    the top ``n_min``."""
    logp = F.log_softmax(logits_up.float(), dim=1)
    valid = label != ignore_index
    lab = torch.where(valid, label, 0).long()
    ce = -torch.gather(logp, 1, lab[:, None])[:, 0]
    ce = torch.where(valid, ce, 0.0).reshape(-1)
    srt = torch.sort(ce, descending=True).values
    th = -torch.log(torch.tensor(thresh, dtype=torch.float32,
                                 device=ce.device))
    hard = srt > th
    mean_above = (srt * hard).sum() / hard.sum().clamp(min=1)
    return torch.where(srt[n_min] > th, mean_above, srt[:n_min].mean())


def td4_loss(outs, batch, **_):
    """main + 0.5 sub + 0.1 aux OHEM losses on the target frame, the logits
    upsampled ``align_corners=True`` (reference td4_psp.py:572-577) →
    (loss, accuracy of main)."""
    main, sub, aux = outs
    label = batch["labels"][-1]
    b, h, w = label.shape
    n_min = b * h * w // 16

    def up(x):
        return resize_bilinear(x.float(), (h, w), align_corners=True)

    main_up = up(main)
    loss = (ohem_ce_loss(main_up, label, n_min)
            + 0.5 * ohem_ce_loss(up(sub), label, n_min)
            + 0.1 * ohem_ce_loss(up(aux), label, n_min))
    return loss, pixel_acc(main_up.detach(),
                           torch.where(label == 255, -1, label))


def td4_tokens(h: int, w: int) -> int:
    """Tokens of the carry for frames (or buckets) of h x w: the stride-3
    grid over the output-stride-8 features."""
    def os8(x):                  # three stride-2 convs / pools, k3 p1
        for _ in range(3):
            x = (x - 1) // 2 + 1
        return x
    return math.ceil(os8(h) / 3) * math.ceil(os8(w) / 3)
