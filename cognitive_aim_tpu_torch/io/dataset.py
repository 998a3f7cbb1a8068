"""Depth dataset (counterpart of cognitive_aim_tpu/io/dataset.py):
annotations or directory scan, npy depth maps, EXIF; host-side numpy
batches, which the trainer moves to the device.

Mirrors `DepthDataset` / `create_dataloaders` / `collate_fn`
(ref:src/dataset.py) with the reference's latent bugs resolved:
  * the custom collate was never wired (ref:src/dataset.py:215-258 creates
    DataLoaders without collate_fn, while train.py reads the plural
    `batch['images']` keys, ref:train.py:135) — here batches always use the
    plural schema images/depths/image_ids/exif;
  * EXIF key `camera_id` vs `camera_idx` standardized to `camera_idx`;
  * `tuple(config['dataset']['image_size'])` on an int (ref:src/dataset.py:227)
    — sizes accept int / [s] / [h, w].

Augmentation (train split): horizontal flip p=0.5 and brightness/contrast/
saturation jitter 0.1 (ref:src/dataset.py:87-89), implemented on numpy host
arrays with an explicit np.random.Generator.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from cognitive_aim_tpu_torch.io import exif as exif_io
from cognitive_aim_tpu_torch.io.preprocess import (
    IMAGENET_MEAN_NP as IMAGENET_MEAN,
    IMAGENET_STD_NP as IMAGENET_STD,
    load_image_uint8,
    pil_resize_host,
)
from cognitive_aim_tpu_torch.nn.torch_interp import resize_weights


def _as_hw(image_size) -> tuple[int, int]:
    if isinstance(image_size, int):
        return (image_size, image_size)
    if isinstance(image_size, Sequence):
        if len(image_size) == 1:
            return (int(image_size[0]), int(image_size[0]))
        return (int(image_size[0]), int(image_size[1]))
    raise TypeError(f"bad image_size: {image_size!r}")


class DepthDataset:
    """Loads `{split}_annotations.json` or falls back to scanning
    images/ + depths/*_depth.npy pairs (ref:src/dataset.py:41-77)."""

    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        image_size=(384, 384),
        use_exif: bool = True,
        augment: bool = True,
        seed: int = 0,
    ):
        self.data_dir = data_dir
        self.split = split
        self.image_size = _as_hw(image_size)
        self.use_exif = use_exif
        self.augment = augment and split == "train"
        self.rng = np.random.default_rng(seed)
        self.annotations = self._load_annotations()
        self.camera_to_id = self._build_camera_mapping()

    # ------------------------------------------------------------ index ----
    def _load_annotations(self) -> List[Dict]:
        ann_file = os.path.join(self.data_dir, f"{self.split}_annotations.json")
        if os.path.exists(ann_file):
            with open(ann_file) as f:
                return json.load(f)
        return self._scan_directory()

    def _scan_directory(self) -> List[Dict]:
        annotations = []
        images_dir = os.path.join(self.data_dir, "images")
        depths_dir = os.path.join(self.data_dir, "depths")
        if not os.path.exists(images_dir):
            return []
        for img_file in sorted(os.listdir(images_dir)):
            if not img_file.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            depth_file = (
                img_file.replace(".jpg", "_depth.npy")
                .replace(".jpeg", "_depth.npy")
                .replace(".png", "_depth.npy")
            )
            depth_path = os.path.join(depths_dir, depth_file)
            if os.path.exists(depth_path):
                annotations.append(
                    {
                        "image_path": os.path.join(images_dir, img_file),
                        "depth_path": depth_path,
                        "image_id": len(annotations),
                    }
                )
        return annotations

    def _build_camera_mapping(self) -> Dict[str, int]:
        """ref:src/dataset.py:93-107 — scan all images' EXIF for models."""
        camera_models = set()
        if self.use_exif:
            for ann in self.annotations:
                raw = exif_io.extract_exif(ann["image_path"])
                if raw and "Model" in raw:
                    camera_models.add(raw["Model"])
        mapping = {m: i for i, m in enumerate(sorted(camera_models))}
        mapping["unknown"] = len(mapping)
        return mapping

    def __len__(self) -> int:
        return len(self.annotations)

    # ------------------------------------------------------------- item ----
    def __getitem__(self, idx: int) -> Dict:
        ann = self.annotations[idx]
        u8 = load_image_uint8(ann["image_path"])
        img = pil_resize_host(u8, *self.image_size)  # [H, W, 3] in [0,1]
        if self.augment:
            img = self._augment(img)
        img = (img - IMAGENET_MEAN) / IMAGENET_STD

        H, W = self.image_size
        depth_path = ann.get("depth_path")
        if depth_path and os.path.exists(depth_path):
            depth = np.load(depth_path).astype(np.float32)
            # torch-bilinear resize + min-max normalize (ref:src/dataset.py:168-181)
            Wh = resize_weights(depth.shape[0], H, "bilinear")
            Ww = resize_weights(depth.shape[1], W, "bilinear")
            depth = Wh @ depth @ Ww.T
            depth = (depth - depth.min()) / (depth.max() - depth.min() + 1e-8)
        else:
            depth = np.zeros(self.image_size, np.float32)

        sample = {"image": img.astype(np.float32), "depth": depth,
                  "image_id": ann.get("image_id", idx)}
        if self.use_exif:
            raw = exif_io.extract_exif(ann["image_path"])
            norm = exif_io.normalize_exif_dataset(raw, self.camera_to_id)
            sample["exif"] = {
                "focal_length": np.float32(norm["focal_length"]),
                "aperture": np.float32(norm["aperture"]),
                "iso": np.float32(norm["iso"]),
                "camera_idx": np.int32(norm["camera_idx"]),
            }
        return sample

    def _augment(self, img: np.ndarray) -> np.ndarray:
        """HFlip(0.5) + ColorJitter(0.1/0.1/0.1) (ref:src/dataset.py:87-89)."""
        if self.rng.random() < 0.5:
            img = img[:, ::-1, :]
        b = 1.0 + self.rng.uniform(-0.1, 0.1)
        c = 1.0 + self.rng.uniform(-0.1, 0.1)
        s = 1.0 + self.rng.uniform(-0.1, 0.1)
        img = np.clip(img * b, 0, 1)
        mean = img.mean()
        img = np.clip((img - mean) * c + mean, 0, 1)
        gray = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
        img = np.clip(gray[..., None] + (img - gray[..., None]) * s, 0, 1)
        return img


def collate(batch: List[Dict]) -> Dict:
    """Plural-key batch schema (ref:src/dataset.py:261-280)."""
    out = {
        "images": np.stack([b["image"] for b in batch]),
        "depths": np.stack([b["depth"] for b in batch]),
        "image_ids": np.asarray([b["image_id"] for b in batch]),
    }
    if "exif" in batch[0]:
        out["exif"] = {
            k: np.stack([b["exif"][k] for b in batch]) for k in batch[0]["exif"]
        }
    return out


class DataLoader:
    """Minimal host loader: shuffling, batching, drop_last — the reference's
    torch DataLoader surface used by the trainer (ref:src/dataset.py:241-256).
    Runs single-process (PrefetchLoader overlaps it with the device);
    batches are numpy; the trainer moves them to the device."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield collate([self.dataset[int(i)] for i in chunk])


class PrefetchLoader:
    """Background-thread prefetch wrapper: overlaps host-side decode/augment
    with device compute (the reference relies on torch DataLoader workers,
    ref:src/dataset.py:219; here a bounded queue + one producer thread)."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        END = object()

        def produce():
            try:
                for batch in self.loader:
                    q.put(batch)
            finally:
                q.put(END)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is END:
                return
            yield item


def create_dataloaders(data_dir: str, config: Dict, batch_size: Optional[int] = None,
                       seed: int = 0):
    """ref:src/dataset.py:215-258, with config-key fallbacks the reference
    crashes on (§2.4): image_size int-or-list, missing dataset.use_exif /
    training.augmentation.enable default True."""
    ds_cfg = config.get("dataset", {})
    image_size = _as_hw(ds_cfg.get("image_size", 384))
    use_exif = bool(ds_cfg.get("use_exif", True))
    aug_cfg = config.get("training", {}).get("augmentation", {})
    augment = bool(
        aug_cfg.get("enable", ds_cfg.get("augmentation", True))
        if isinstance(aug_cfg, dict)
        else True
    )
    if batch_size is None:
        batch_size = int(config.get("training", {}).get("batch_size", 8))

    train_ds = DepthDataset(data_dir, "train", image_size, use_exif, augment, seed)
    val_ds = DepthDataset(data_dir, "val", image_size, use_exif, False, seed)
    train_loader = PrefetchLoader(
        DataLoader(train_ds, batch_size, shuffle=True, drop_last=True, seed=seed)
    )
    train_loader.dataset = train_ds
    val_loader = DataLoader(val_ds, batch_size, shuffle=False)
    return train_loader, val_loader
