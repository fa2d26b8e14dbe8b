"""Image datasets: folder loading, augmentation, and DiT latent datasets
(the port's own copy of ``mhla_tpu/data/image_data.py``, which imports no
JAX either; the two must read the same files the same way).

- :class:`ImageFolderDataset` — ImageNet-layout folder (class subdirs) with
  train-time augmentation (random-resized-crop, hflip, RandAugment, random
  erasing: the timm recipe) or eval-time resize + center-crop.
- :func:`center_crop_arr` — the ADM-style deterministic crop of DiT feature
  extraction.
- :class:`LatentDataset` — pre-extracted VAE latent / label ``.npy`` pairs
  (``imagenet256_features`` / ``imagenet256_labels``) or flat ``.npz``
  files.

Everything yields numpy arrays (host side); the trainers move them to the
device. PIL is the only image dependency, imported where an image is read,
so the synthetic streams and the latent datasets run without it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def _require_pil():
    try:
        from PIL import Image  # noqa: F401

        return Image
    except ImportError as e:  # pragma: no cover
        raise ImportError("image datasets require Pillow") from e


def list_image_folder(root: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """ImageNet layout: root/<class_name>/<image>. Returns (samples, classes)."""
    rootp = Path(root)
    classes = sorted(p.name for p in rootp.iterdir() if p.is_dir())
    class_to_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        for f in sorted((rootp / c).rglob("*")):
            if f.suffix.lower() in IMG_EXTS:
                samples.append((str(f), class_to_idx[c]))
    return samples, classes


def center_crop_arr(img, image_size: int) -> np.ndarray:
    """ADM-style center crop: downsample by powers of 2 while big, resize so
    the short side is ``image_size``, then center-crop (the reference's DiT
    feature-extraction transform)."""
    Image = _require_pil()
    while min(*img.size) >= 2 * image_size:
        img = img.resize(
            tuple(x // 2 for x in img.size), resample=Image.BOX
        )
    scale = image_size / min(*img.size)
    img = img.resize(
        tuple(round(x * scale) for x in img.size), resample=Image.BICUBIC
    )
    arr = np.asarray(img.convert("RGB"))
    y = (arr.shape[0] - image_size) // 2
    x = (arr.shape[1] - image_size) // 2
    return arr[y : y + image_size, x : x + image_size]


# ---------------------------------------------------------------------------
# RandAugment (timm recipe 'rand-m9-mstd0.5' spirit) on PIL images
# ---------------------------------------------------------------------------


def _randaugment(img, rng: np.random.Generator, n_ops: int = 2, magnitude: int = 9):
    Image = _require_pil()
    from PIL import ImageEnhance, ImageOps

    m = magnitude / 30.0  # normalized magnitude

    def shear_x(im, v):
        return im.transform(im.size, Image.AFFINE, (1, v, 0, 0, 1, 0))

    def shear_y(im, v):
        return im.transform(im.size, Image.AFFINE, (1, 0, 0, v, 1, 0))

    def translate_x(im, v):
        return im.transform(im.size, Image.AFFINE, (1, 0, v * im.size[0], 0, 1, 0))

    def translate_y(im, v):
        return im.transform(im.size, Image.AFFINE, (1, 0, 0, 0, 1, v * im.size[1]))

    ops = [
        lambda im: ImageOps.autocontrast(im),
        lambda im: ImageOps.equalize(im),
        lambda im: ImageOps.posterize(im, max(1, int(8 - 4 * m))),
        lambda im: ImageOps.solarize(im, int(256 * (1 - m))),
        lambda im: im.rotate(rng.choice([-1, 1]) * 30 * m),
        lambda im: ImageEnhance.Color(im).enhance(1 + rng.choice([-1, 1]) * 0.9 * m),
        lambda im: ImageEnhance.Contrast(im).enhance(1 + rng.choice([-1, 1]) * 0.9 * m),
        lambda im: ImageEnhance.Brightness(im).enhance(1 + rng.choice([-1, 1]) * 0.9 * m),
        lambda im: ImageEnhance.Sharpness(im).enhance(1 + rng.choice([-1, 1]) * 0.9 * m),
        lambda im: shear_x(im, rng.choice([-1, 1]) * 0.3 * m),
        lambda im: shear_y(im, rng.choice([-1, 1]) * 0.3 * m),
        lambda im: translate_x(im, rng.choice([-1, 1]) * 0.45 * m),
        lambda im: translate_y(im, rng.choice([-1, 1]) * 0.45 * m),
    ]
    for idx in rng.integers(0, len(ops), n_ops):
        img = ops[int(idx)](img)
    return img


def random_erasing(
    arr: np.ndarray, rng: np.random.Generator, prob: float = 0.25
) -> np.ndarray:
    """timm-style random erasing on a [H, W, C] float array (per-pixel noise)."""
    if rng.random() >= prob:
        return arr
    h, w = arr.shape[:2]
    area = h * w * rng.uniform(0.02, 0.33)
    aspect = np.exp(rng.uniform(np.log(0.3), np.log(3.3)))
    eh = min(h, max(1, int(round(np.sqrt(area * aspect)))))
    ew = min(w, max(1, int(round(np.sqrt(area / aspect)))))
    y = rng.integers(0, h - eh + 1)
    x = rng.integers(0, w - ew + 1)
    arr = arr.copy()
    arr[y : y + eh, x : x + ew] = rng.standard_normal(
        (eh, ew, arr.shape[2])
    ).astype(arr.dtype)
    return arr


@dataclasses.dataclass
class ImageAugConfig:
    img_size: int = 224
    train: bool = True
    hflip: float = 0.5
    scale: Tuple[float, float] = (0.08, 1.0)
    ratio: Tuple[float, float] = (3 / 4, 4 / 3)
    randaugment: bool = True
    ra_ops: int = 2
    ra_magnitude: int = 9
    erasing_prob: float = 0.25
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)  # imagenet
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


class ImageFolderDataset:
    """ImageNet-layout folder -> [B, H, W, 3] float batches + int labels.

    Deterministic given (seed, epoch); infinite iterator over shuffled
    epochs. Timm-recipe augmentation for train, resize+center-crop for eval.
    """

    def __init__(self, root: str, cfg: ImageAugConfig, seed: int = 0):
        self.cfg = cfg
        self.samples, self.classes = list_image_folder(root)
        if not self.samples:
            raise ValueError(f"no images under {root}")
        self.seed = seed

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def _load(self, path: str, rng: np.random.Generator) -> np.ndarray:
        Image = _require_pil()
        cfg = self.cfg
        img = Image.open(path).convert("RGB")
        if cfg.train:
            # random resized crop
            for _ in range(10):
                area = img.size[0] * img.size[1] * rng.uniform(*cfg.scale)
                aspect = np.exp(rng.uniform(*np.log(cfg.ratio)))
                w = int(round(np.sqrt(area * aspect)))
                h = int(round(np.sqrt(area / aspect)))
                if w <= img.size[0] and h <= img.size[1]:
                    x = rng.integers(0, img.size[0] - w + 1)
                    y = rng.integers(0, img.size[1] - h + 1)
                    img = img.crop((x, y, x + w, y + h))
                    break
            img = img.resize((cfg.img_size, cfg.img_size), Image.BICUBIC)
            if rng.random() < cfg.hflip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if cfg.randaugment:
                img = _randaugment(img, rng, cfg.ra_ops, cfg.ra_magnitude)
            arr = np.asarray(img, np.float32) / 255.0
            arr = (arr - cfg.mean) / cfg.std
            arr = random_erasing(arr.astype(np.float32), rng, cfg.erasing_prob)
        else:
            arr = center_crop_arr(img, cfg.img_size).astype(np.float32) / 255.0
            arr = ((arr - cfg.mean) / cfg.std).astype(np.float32)
        return arr.astype(np.float32)

    def batches(
        self, batch_size: int, epoch: int = 0
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One epoch of [B, H, W, 3] float32 batches (drops the remainder)."""
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.samples))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            xs = np.stack(
                [self._load(self.samples[i][0], rng) for i in idx]
            )
            ys = np.asarray([self.samples[i][1] for i in idx], np.int32)
            yield xs, ys

    def infinite(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        epoch = 0
        while True:
            yield from self.batches(batch_size, epoch)
            epoch += 1


class LatentDataset:
    """Pre-extracted VAE latents (reference layout: ``<root>/
    imagenet256_features/N.npy`` + ``imagenet256_labels/N.npy``, each
    feature file [K, 4, 32, 32] holding flip variants)."""

    def __init__(self, root: str, seed: int = 0):
        rootp = Path(root)
        self.feat_dir = rootp / "imagenet256_features"
        self.label_dir = rootp / "imagenet256_labels"
        if not self.feat_dir.exists():  # flat fallback: *.npz with latent/label
            self.feat_dir = rootp
            self.label_dir = None
        self.files = sorted(self.feat_dir.glob("*.np[yz]"))
        if not self.files:
            raise ValueError(f"no latents under {root}")
        self.seed = seed

    def _load(self, f: Path, rng) -> Tuple[np.ndarray, int]:
        if f.suffix == ".npz":
            blob = np.load(f)
            return blob["latent"].astype(np.float32), int(blob["label"])
        feats = np.load(f).astype(np.float32)  # [K, C, H, W] (torch layout)
        if feats.ndim == 4:  # pick one flip variant
            feats = feats[rng.integers(0, feats.shape[0])]
        lab = 0
        if self.label_dir is not None:
            lab = int(np.load(self.label_dir / f.name).reshape(-1)[0])
        return feats, lab

    def infinite(
        self, batch_size: int
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """[B, H, W, C] latent batches (NCHW .npy transposed to NHWC)."""
        epoch = 0
        while True:
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(len(self.files))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[start : start + batch_size]
                feats, labs = zip(*(self._load(self.files[i], rng) for i in idx))
                x = np.stack(feats)
                if x.shape[1] in (4, 8, 16) and x.shape[1] < x.shape[-1]:
                    x = x.transpose(0, 2, 3, 1)  # NCHW -> NHWC
                yield x.astype(np.float32), np.asarray(labs, np.int32)
            epoch += 1
