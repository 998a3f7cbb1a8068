"""EXIF extraction & normalization (the port's copy of
cognitive_aim_tpu/io/exif.py, held equal to it by the tests; host-side, PIL
stays off the device path and is imported inside the functions).

Reproduces both reference EXIF pipelines:
  * the inference pipeline (ref:demo.py:170-296): plausibility ranges
    (focal 10-500mm, f/1-32, exposure 1e-4..30s, ISO 50-25600), fraction
    handling, and RAW-unit defaults 50mm / f2.8 / ISO100 / camera 0;
  * the dataset pipeline (ref:src/dataset.py:109-155): normalization to [0,1]
    by /200, /22, /6400 with clamping and defaults.

The key-name mismatch in the reference (dataset emits `camera_id`,
ref:src/dataset.py:201, while the model consumes `camera_idx`,
ref:src/model.py:491) is resolved: both pipelines emit `camera_idx`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def extract_exif(image_path: str) -> Optional[Dict[str, Any]]:
    """Raw EXIF fields with plausibility filtering (ref:demo.py:170-255)."""
    try:
        import warnings

        from PIL import Image

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return extract_exif_from_pil(Image.open(image_path))
    except Exception:
        return None


def _filter_exif_tags(exif_data: Optional[Dict]) -> Optional[Dict[str, Any]]:
    """Shared tag filtering/plausibility pass (ref:demo.py:177-255) over a
    raw {tag_id: value} dict."""
    if exif_data is None:
        return None
    from PIL.ExifTags import TAGS

    def safe_val(value):
        try:
            if isinstance(value, tuple) and len(value) == 2:
                return float(value[0]) / float(value[1])
            if isinstance(value, (int, float)):
                return float(value)
            return float(str(value))
        except Exception:
            return None

    extracted: Dict[str, Any] = {}
    for tag_id, value in exif_data.items():
        try:
            tag = TAGS.get(tag_id, tag_id)
            if tag == "FocalLength":
                v = safe_val(value)
                if v and 10 <= v <= 500:
                    extracted["FocalLength"] = v
            elif tag == "FNumber":
                v = safe_val(value)
                if v and 1.0 <= v <= 32.0:
                    extracted["FNumber"] = v
            elif tag == "ExposureTime":
                v = safe_val(value)
                if v and 0.0001 <= v <= 30.0:
                    extracted["ExposureTime"] = v
            elif tag == "ISOSpeedRatings":
                v = safe_val(value)
                if v and 50 <= v <= 25600:
                    extracted["ISOSpeedRatings"] = int(v)
            elif tag in ("Make", "Model"):
                if isinstance(value, str) and value.strip():
                    extracted[tag] = value.strip()
        except Exception:
            continue
    return extracted or None


def extract_exif_from_pil(image) -> Optional[Dict[str, Any]]:
    """extract_exif for an already-open PIL image (in-memory uploads — the
    HTTP serving path — carry EXIF too; same plausibility ranges)."""
    try:
        try:
            exif_data = image._getexif()
        except Exception:
            try:
                exif_data = dict(image.getexif().items()) or None
            except Exception:
                exif_data = None
        return _filter_exif_tags(exif_data)
    except Exception:
        return None


def extract_exif_from_app1(payload: Optional[bytes]) -> Optional[Dict[str, Any]]:
    """extract_exif from a raw EXIF APP1 payload ("Exif\\0\\0" + TIFF blob)
    as returned by the native loader — parses tags WITHOUT reopening or
    re-decoding the image file (the loader captured the bytes during its
    single decode pass). Merges IFD0 (Make/Model) with the Exif SubIFD
    (FocalLength/FNumber/ISO/ExposureTime), matching PIL._getexif()."""
    if not payload:
        return None
    try:
        from PIL import Image

        ex = Image.Exif()
        ex.load(payload)
        merged = dict(ex.items())
        try:
            merged.update(ex.get_ifd(0x8769))
        except Exception:
            pass
        return _filter_exif_tags(merged or None)
    except Exception:
        return None


def read_exif_app1(image_path: str) -> Optional[bytes]:
    """Pure-Python APP1 scan (no pixel decode) — fallback when the native
    loader is unavailable: walk the JPEG marker stream until SOS and return
    the EXIF payload bytes."""
    try:
        with open(image_path, "rb") as f:
            if f.read(2) != b"\xff\xd8":
                return None
            while True:
                marker = f.read(2)
                if len(marker) < 2 or marker[0] != 0xFF:
                    return None
                if marker[1] in (0xDA, 0xD9):  # SOS / EOI: no EXIF
                    return None
                ln = int.from_bytes(f.read(2), "big")
                body = f.read(ln - 2)
                if marker[1] == 0xE1 and body.startswith(b"Exif\x00\x00"):
                    return body
    except Exception:
        return None


DEFAULTS_RAW = {"focal_length": 50.0, "aperture": 2.8, "iso": 100.0, "camera_idx": 0}


def exif_arrays_for_model(
    exif_raw: Optional[Dict[str, Any]],
    camera_to_id: Optional[Dict[str, int]] = None,
) -> Dict[str, np.ndarray]:
    """Inference-path tensorization with RAW units (ref:demo.py:257-296);
    batch size 1 arrays."""
    camera_to_id = camera_to_id or {"unknown": 0}
    if exif_raw is not None:
        vals = {
            "focal_length": float(exif_raw.get("FocalLength", 50.0)),
            "aperture": float(exif_raw.get("FNumber", 2.8)),
            "iso": float(exif_raw.get("ISOSpeedRatings", 100)),
            "camera_idx": int(
                camera_to_id.get(exif_raw.get("Model", "unknown"), 0)
            ),
        }
    else:
        vals = dict(DEFAULTS_RAW)
    return {
        "focal_length": np.asarray([vals["focal_length"]], np.float32),
        "aperture": np.asarray([vals["aperture"]], np.float32),
        "iso": np.asarray([vals["iso"]], np.float32),
        "camera_idx": np.asarray([vals["camera_idx"]], np.int32),
    }


def normalize_exif_dataset(
    exif_raw: Optional[Dict[str, Any]], camera_to_id: Dict[str, int]
) -> Dict[str, float]:
    """Training-path normalization (ref:src/dataset.py:143-155) with the
    reference's defaults when EXIF is absent (ref:src/dataset.py:204-210)."""
    if exif_raw is None:
        return {
            "focal_length": 0.25,  # 50mm / 200
            "aperture": 0.127,  # f2.8 / 22 (ref rounds to 0.127)
            "iso": 0.016,  # ISO100 / 6400 (ref rounds to 0.016)
            "camera_idx": camera_to_id.get("unknown", 0),
        }
    # the dataset path uses dataset-style keys (ref:src/dataset.py:109-138)
    focal = exif_raw.get("focal_length", exif_raw.get("FocalLength", 50.0))
    aperture = exif_raw.get("aperture", exif_raw.get("FNumber", 2.8))
    iso = exif_raw.get("iso", exif_raw.get("ISOSpeedRatings", 100.0))
    model = exif_raw.get("camera_model", exif_raw.get("Model", "unknown"))
    return {
        "focal_length": min(max(float(focal), 10.0), 200.0) / 200.0,
        "aperture": min(max(float(aperture), 1.0), 22.0) / 22.0,
        "iso": min(max(float(iso), 50.0), 6400.0) / 6400.0,
        "camera_idx": camera_to_id.get(model, camera_to_id.get("unknown", 0)),
    }
