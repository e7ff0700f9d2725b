"""VSPW-480p data: layout, normalization, label remap, frame and clip
sampling and augmentation (copies of the JAX package's data/datasets.py
primitives, ``FrameDataset``, ``ClipDataset``, ``LongClipDataset``,
``TestFrameDataset`` and ``TestClipDataset``).

Layout ``<root>/data/<video>/{origin,mask}/*`` with ``<root>/<split>.txt``
video lists; ImageNet mean/std normalization; label remap 0→255 (ignore),
v→v-1, 254→255 (reference dataset2.py:531-533, 602-609).  Train
augmentation: one flip, one multiscale {0.8, 1, 1.5, 2} PIL resize (bilinear
image, nearest mask), one pad-to-cropsize (image 0, label 255) and one
random crop shared by the clip (dataset2.py:806-845).  Clip sampling: a
contiguous run from a random dilated sublist (dataset2.py:780-849), or an
anchor plus offsets with p=0.5 temporal reversal (dataset2.py:984-1048).
Frames decode with PIL; uint8 normalization and the label remap take the
native one-pass ops (``native``).  The clip datasets draw from ``random.Random(seed)`` and
``np.random.default_rng(seed)`` in the JAX package's order, and
``FrameDataset`` from generators keyed by (seed, epoch, index), so one seed
gives both packages the same batches.  With ``args.refrng`` every train
dataset draws from the global ``random`` and ``np.random`` streams instead,
in the JAX package's (and the reference's) call order; the loader's one
worker thread makes those draws.  ``TwoDataset`` (``--usetwodata``) pairs
each VSPW frame with one drawn from a second root.  Outputs are HWC numpy:
images float32 normalized, labels int32.
"""

from __future__ import annotations

import copy
import os
import random
from typing import Sequence

import numpy as np
from PIL import Image

from .. import native

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] → ImageNet-normalized float32; uint8 takes the one-pass
    native op (``native.normalize_u8``)."""
    if img.dtype == np.uint8:
        return native.normalize_u8(img)
    return (img - MEAN) / STD


def remap_label(segm: np.ndarray) -> np.ndarray:
    """Mask remap (reference: dataset2.py:602-609): 0→255, v→v-1, 254→255."""
    if segm.dtype == np.uint8:
        return native.remap_label_u8(segm)
    segm = segm.astype(np.int32)
    out = segm - 1
    out[segm == 0] = 255
    out[out == 254] = 255
    return out


def load_frame(dataroot: str, video: str, imgname: str,
               lesslabel: bool = False):
    """(PIL image RGB, PIL mask) of one frame."""
    img = Image.open(os.path.join(dataroot, "data", video, "origin",
                                  imgname)).convert("RGB")
    maskdir = "mask_42label" if lesslabel else "mask"
    mask = Image.open(os.path.join(dataroot, "data", video, maskdir,
                                   os.path.splitext(imgname)[0] + ".png"))
    return img, mask


def list_videos(dataroot: str, split: str) -> list[str]:
    with open(os.path.join(dataroot, split + ".txt")) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def list_frames(dataroot: str, video: str) -> list[str]:
    return sorted(os.listdir(os.path.join(dataroot, "data", video, "origin")))


def dilation_lists(frames: Sequence[str], num: int) -> list[list[str]]:
    """Split frames into num+1 stride-(num+1) sublists (dataset2.py:143-151)."""
    return [[f for k, f in enumerate(frames) if k % (num + 1) == a]
            for a in range(num + 1)]


SCALES = (0.8, 1.0, 1.5, 2.0)


def _rng_handles(args, seed):
    """Per-dataset generators (python-random-like, numpy-random-like), or
    with ``args.refrng`` the global ``random`` and ``np.random`` streams
    (JAX ``_rng_handles``)."""
    if getattr(args, "refrng", False):
        return random, np.random
    return random.Random(seed), np.random.default_rng(seed)


def _item_rng_handles(args, seed, epoch: int, idx: int):
    """Generators of one item's draws, keyed by (seed, epoch, index): random
    across epochs, and the same whatever was drawn before; with
    ``args.refrng`` the global streams (JAX ``_item_rng_handles``)."""
    if getattr(args, "refrng", False):
        return random, np.random
    mix = (seed or 0) * 1_000_003 + epoch * 65_537 + idx
    return random.Random(mix), np.random.default_rng(mix)


def _augment_frame(img: Image.Image, mask: Image.Image, flip: bool,
                   scale: float):
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
    if scale != 1.0:
        w, h = img.size
        img = img.resize((int(w * scale), int(h * scale)), Image.BILINEAR)
        mask = mask.resize((int(w * scale), int(h * scale)), Image.NEAREST)
    return img, mask


def _pad_crop_clip(imgs: list[np.ndarray], labels: list[np.ndarray],
                   cropsize: tuple[int, int], rng: random.Random):
    """Shared pad + random crop across a clip (dataset2.py:806-845).

    Pads symmetrically by the deficit (the reference pads (pad, pad) on both
    sides) with 0 for images / 255 for labels, then one crop offset for all.
    """
    ch, cw = cropsize
    h, w = imgs[0].shape[:2]
    padh = ch - h if h < ch else 0
    padw = cw - w if w < cw else 0
    ph, pw = h + 2 * padh, w + 2 * padw
    x = rng.randint(0, pw - cw)
    y = rng.randint(0, ph - ch)
    out_i, out_l = [], []
    for img, lab in zip(imgs, labels):
        if padh or padw:
            img = np.pad(img, ((padh, padh), (padw, padw), (0, 0)), "constant")
            lab = np.pad(lab, ((padh, padh), (padw, padw)), "constant",
                         constant_values=255)
        out_i.append(img[y:y + ch, x:x + cw])
        out_l.append(lab[y:y + ch, x:x + cw])
    return out_i, out_l


class FrameDataset:
    """Single-frame train dataset (reference BaseDataset,
    dataset2.py:494-654): every ``int(15 / trainfps)``-th frame of each
    video, a flip and (``--multi_scale``) a scale, then pad and a random crop
    of ``cropsize`` (480x720 with ``--train_filter``), each item's draws from
    :func:`_item_rng_handles` at the epoch that :meth:`set_epoch` gave."""

    def __init__(self, args, split: str = "train", seed: int | None = None):
        self.args = args
        self.split = split
        self.dataroot = args.dataroot
        self.cropsize = (480, 720) if getattr(args, "train_filter", False) \
            else (args.cropsize, args.cropsize)
        trainfps = 1 if split == "val" else args.trainfps
        self.seed = seed or 0
        self.epoch = 0
        num = int(15.0 / trainfps)
        self.imglist: list[tuple[str, str]] = []
        for video in list_videos(self.dataroot, split):
            frames = list_frames(self.dataroot, video)
            self.imglist.extend((video, f) for k, f in enumerate(frames)
                                if k % num == 0)

    def __len__(self):
        return len(self.imglist)

    def set_epoch(self, epoch: int):
        """Key the items' draws by ``epoch`` (the loader calls it)."""
        self.epoch = int(epoch)

    def __getitem__(self, idx):
        video, name = self.imglist[idx]
        img, mask = load_frame(self.dataroot, video, name,
                               getattr(self.args, "lesslabel", False))
        rng, nprng = _item_rng_handles(self.args, self.seed, self.epoch,
                                       int(idx))
        if self.split == "train":
            flip = bool(nprng.choice([0, 1]))
            scale = float(nprng.choice(SCALES)) \
                if getattr(self.args, "multi_scale", False) else 1.0
            img, mask = _augment_frame(img, mask, flip, scale)
        arr = np.asarray(img)             # uint8 until after the crop
        lab = remap_label(np.asarray(mask))
        if self.split == "train":
            [arr], [lab] = _pad_crop_clip([arr], [lab], self.cropsize, rng)
        return normalize_image(arr), lab


class ClipDataset:
    """Contiguous-clip train dataset (BaseDataset_clip, dataset2.py:657-849).

    Samples ``clip_num`` consecutive frames from a random temporally-dilated
    sublist of one video, with one shared flip/scale/crop for the clip.
    """

    def __init__(self, args, split: str = "train", seed: int | None = None):
        self.args = args
        self.split = split
        self.dataroot = args.dataroot
        self.cropsize = (args.cropsize, args.cropsize)
        self.clip_num = args.clip_num
        self.dilation = args.dilation_num
        self.rng, self.nprng = _rng_handles(args, seed)
        self.videolists = list_videos(self.dataroot, split)
        self.imgdic = {v: list_frames(self.dataroot, v) for v in self.videolists}

    def __len__(self):
        return len(self.videolists)

    def __getitem__(self, idx):
        video = self.videolists[idx]
        frames = list(self.imgdic[video])
        sublists = dilation_lists(frames, self.dilation)
        sub = sublists[0]
        for _ in range(10):
            sub = sublists[int(self.nprng.choice(len(sublists)))]
            if len(sub) > self.clip_num:
                break
        sub = list(sub)
        while len(sub) <= self.clip_num:
            sub.append(sub[-1])
        start = int(self.nprng.choice(len(sub) - self.clip_num))
        names = sub[start:start + self.clip_num]
        return self._load_clip(video, names)

    def _load_clip(self, video, names):
        flip = bool(self.nprng.choice([0, 1]))
        # the reference draws the scale unconditionally and only APPLIES it
        # under multi_scale (dataset2.py:807-825, 990-1010)
        scale = float(self.nprng.choice(SCALES))
        if not getattr(self.args, "multi_scale", False):
            scale = 1.0
        lesslabel = getattr(self.args, "lesslabel", False)
        imgs, labs = [], []
        for name in names:
            img, mask = load_frame(self.dataroot, video, name, lesslabel)
            if self.split == "train":
                img, mask = _augment_frame(img, mask, flip, scale)
            imgs.append(np.asarray(img))  # uint8 until after the crop
            labs.append(remap_label(np.asarray(mask)))
        if self.split == "train":
            imgs, labs = _pad_crop_clip(imgs, labs, self.cropsize, self.rng)
        return ([normalize_image(i) for i in imgs], labs)


class LongClipDataset(ClipDataset):
    """Anchor+offsets train dataset (BaseDataset_longclip, dataset2.py:852-1048).

    Frame order is [anchor, anchor+d1, ..., anchor+dk]; the whole video is
    temporally reversed with p=0.5 before sampling the anchor.
    """

    def __init__(self, args, split: str = "train", seed: int | None = None):
        super().__init__(args, split, seed)
        dil = args.dilation2
        self.dilation2 = [int(d) for d in dil.split(",")] \
            if isinstance(dil, str) else list(dil)
        if len(self.dilation2) + 1 != self.clip_num:
            raise ValueError("dilation2 must hold clip_num - 1 offsets")

    def __getitem__(self, idx):
        video = self.videolists[idx]
        frames = list(self.imgdic[video])
        if self.nprng.random() < 0.5:
            frames = frames[::-1]
        usable = frames[:-self.dilation2[-1]]
        while len(usable) < 1:
            frames.append(frames[-1])
            usable = frames[:-self.dilation2[-1]]
        anchor = int(self.nprng.choice(len(usable)))
        names = [frames[anchor]] + [frames[anchor + d] for d in self.dilation2]
        return self._load_clip(video, names)


class TwoDataset:
    """A VSPW frame and a frame of a second dataset (``args.dataroot2``, the
    same layout) per item (JAX ``TwoDataset``; reference TwoDataset,
    dataset2.py:1052-1242): item ``idx`` of the primary ``FrameDataset``,
    then an index drawn by the dataset's own ``default_rng(seed)``, a
    stateful stream as JAX's, then that item of the secondary one.  Neither
    is given an epoch: the JAX loader finds no ``set_epoch`` here, so both
    keep epoch 0.  :func:`data.loader.collate_two_frames` batches them."""

    def __init__(self, args, split: str = "train", seed: int | None = None):
        self.primary = FrameDataset(args, split, seed)
        args2 = copy.copy(args)
        args2.dataroot = args.dataroot2
        self.secondary = FrameDataset(args2, split, seed)
        self.nprng = np.random.default_rng(seed)
        self.cropsize = self.primary.cropsize

    def __len__(self):
        return len(self.primary)

    def __getitem__(self, idx):
        first = self.primary[idx]
        j = int(self.nprng.choice(len(self.secondary)))
        return first, self.secondary[j]


class TestFrameDataset:
    """Sequential per-video eval frames (TestDataset, dataset2.py:34-141).
    ``--use_720p`` resizes frame and mask to 1080x720 in the per-frame eval
    only: the reference's clip eval datasets take the flag and ignore it
    (dataset2.py:130-133), and so do the subclasses here."""

    __test__ = False  # not a pytest class

    def __init__(self, dataroot: str, video: str, args):
        self.dataroot = dataroot
        self.video = video
        self.args = args
        self.imglist = list_frames(dataroot, video)

    def __len__(self):
        return len(self.imglist)

    def __getitem__(self, idx):
        name = self.imglist[idx]
        img, mask = load_frame(self.dataroot, self.video, name,
                               getattr(self.args, "lesslabel", False))
        if getattr(self.args, "use_720p", False) \
                and type(self) is TestFrameDataset:
            img = img.resize((1080, 720), Image.BILINEAR)
            mask = mask.resize((1080, 720), Image.NEAREST)
        arr = normalize_image(np.asarray(img))
        lab = remap_label(np.asarray(mask))
        return arr, lab, os.path.splitext(name)[0] + ".png"


class TestClipDataset(TestFrameDataset):
    """Centred neighbour window per eval frame (TestDataset_clip,
    dataset2.py:154-338): within the frame's dilated sublist, a
    ``clip_num`` window centred on it (edge-clamped), the eval frame itself
    excluded from the context.  Items are (image, label, context images,
    context labels, PNG name).  For ``method`` nonlocal3d the eval frame
    stays in its window and the item ends with the window's frame names."""

    def __init__(self, dataroot: str, video: str, args):
        super().__init__(dataroot, video, args)
        self.clip_num = args.clip_num
        self.dilists = dilation_lists(self.imglist, args.dilation_num)
        self.all_frames = getattr(args, "method", "") == "nonlocal3d"

    def __getitem__(self, idx):
        arr, lab, gtname = super().__getitem__(idx)
        name = self.imglist[idx]
        thelist = next(dl for dl in self.dilists if name in dl)
        i = thelist.index(name)
        addleft = self.clip_num // 2
        addright = addleft if self.clip_num % 2 else addleft - 1
        if i - addleft < 0:
            start, end = 0, min(self.clip_num, len(thelist))
        elif i + addright >= len(thelist):
            end = len(thelist)
            start = max(end - self.clip_num, 0)
        else:
            start, end = i - addleft, i - addleft + self.clip_num

        if end - start < 2:
            clips, cliplabs, names = [arr], [lab], [name]
        else:
            clips, cliplabs, names = [], [], []
            lesslabel = getattr(self.args, "lesslabel", False)
            for j in range(start, end):
                if j == i and not self.all_frames:
                    continue
                cimg, cmask = load_frame(self.dataroot, self.video,
                                         thelist[j], lesslabel)
                clips.append(normalize_image(np.asarray(cimg)))
                cliplabs.append(remap_label(np.asarray(cmask)))
                names.append(thelist[j])
        if self.all_frames:
            return arr, lab, clips, cliplabs, gtname, names
        return arr, lab, clips, cliplabs, gtname


class TestLongClipDataset(TestFrameDataset):
    """Anchor + ``dilation2`` offsets per eval frame (TestDataset_longclip,
    dataset2.py:344-490): near the video's end the offsets flip backwards,
    and a negative index wraps as Python's list indexing does.  Items are
    (image, label, context images, context labels, PNG name)."""

    def __init__(self, dataroot: str, video: str, args):
        super().__init__(dataroot, video, args)
        dil = args.dilation2
        self.dilation2 = [int(d) for d in dil.split(",")] \
            if isinstance(dil, str) else list(dil)
        if len(self.dilation2) + 1 != args.clip_num:
            raise ValueError("dilation2 must hold clip_num - 1 offsets")

    def __getitem__(self, idx):
        arr, lab, gtname = super().__getitem__(idx)
        n = len(self.imglist)
        clips, cliplabs = [], []
        lesslabel = getattr(self.args, "lesslabel", False)
        for dil in self.dilation2:
            j = idx - dil if idx + self.dilation2[-1] >= n else idx + dil
            cimg, cmask = load_frame(self.dataroot, self.video,
                                     self.imglist[j], lesslabel)
            clips.append(normalize_image(np.asarray(cimg)))
            cliplabs.append(remap_label(np.asarray(cmask)))
        return arr, lab, clips, cliplabs, gtname
