"""Procedural multi-object scenes whose depth task generalises (counterpart
of scripts/procedural_scenes.py, kept bit for bit: the same seed gives the
same scenes and depths).

  * natural-statistics scenes: smooth gradients and multi-scale value noise,
    6-12 textured occluding distractors, no two images alike;
  * a TARGET (a red-dominant concentric-ring disk, unlike every distractor)
    whose apparent size encodes depth, depth = a + b / (r / S): fitting the
    law means finding the target and reading its scale.

``gen_procedural_aimed`` draws three targets and labels each instruction
with the depth of the target nearest its anchor. Every generator is one
sequential ``np.random.RandomState`` stream, so it is not parallelised;
``pretrain.py`` caches its scenes under ``build/certify/``.

    python -m cognitive_aim_tpu_torch.certify.procedural [N]
"""

import numpy as np

# depth = DEPTH_A + DEPTH_B / (r/S); r/S in RADIUS_FRAC -> depth in
# [0.7, 2.5] — same range the synthetic laws produce, so training
# hyperparameters (lr, loss scale) carry over unchanged.
DEPTH_A, DEPTH_B = 0.2, 0.08
RADIUS_FRAC = (0.035, 0.16)


def _value_noise(rng, size, cells, amp):
    """Bilinearly upsampled random grid — cheap band-limited texture."""
    g = rng.rand(cells + 1, cells + 1).astype(np.float32)
    idx = np.linspace(0, cells, size, dtype=np.float32)
    i0 = np.minimum(idx.astype(np.int32), cells - 1)
    f = idx - i0
    top = g[i0][:, i0] * (1 - f)[None, :] + g[i0][:, i0 + 1] * f[None, :]
    bot = g[i0 + 1][:, i0] * (1 - f)[None, :] + g[i0 + 1][:, i0 + 1] * f[None, :]
    return amp * (top * (1 - f)[:, None] + bot * f[:, None])


def _background(rng, s):
    """Natural-ish background + occluding textured distractors."""
    ys, xs = np.mgrid[0:s, 0:s].astype(np.float32) / s
    # smooth gradient + 1/f-weighted value noise
    base = rng.rand() * ys + rng.rand() * xs + 0.3 * rng.rand()
    tex = (_value_noise(rng, s, 4, 0.30) + _value_noise(rng, s, 12, 0.15)
           + _value_noise(rng, s, 48, 0.07))
    img = np.stack([(base + tex) * (0.3 + 0.7 * rng.rand())
                    for _ in range(3)], axis=-1)

    # occluding textured distractors (drawn back-to-front)
    for _ in range(rng.randint(6, 13)):
        cy, cx = rng.rand(2) * s
        ry, rx = (0.04 + 0.18 * rng.rand(2)) * s
        ang = rng.rand() * np.pi
        ca, sa = np.cos(ang), np.sin(ang)
        dy, dx = np.arange(s)[:, None] - cy, np.arange(s)[None, :] - cx
        u, v = (ca * dx + sa * dy) / rx, (-sa * dx + ca * dy) / ry
        mask = (u * u + v * v) < 1.0
        color = rng.rand(3) * 0.9
        # keep distractors away from the target's signature (red-dominant):
        # red channel never the strict max by a margin
        color[0] = min(color[0], max(color[1], color[2]) * 0.8)
        dtex = _value_noise(rng, s, rng.randint(6, 24), 0.25)
        for c in range(3):
            img[..., c][mask] = color[c] + dtex[mask]
    return img


def _draw_target(img, s, r, cy, cx):
    """Red-dominant concentric-ring disk of radius r at (cy, cx); the ring
    texture scales with the disk so the pattern (not just color) marks the
    target at every scale."""
    dy, dx = np.arange(s)[:, None] - cy, np.arange(s)[None, :] - cx
    dist = np.sqrt(dy * dy + dx * dx)
    mask = dist < r
    rings = 0.5 + 0.5 * np.sin(dist / max(r, 1.0) * 6 * np.pi)
    img[..., 0][mask] = 0.75 + 0.25 * rings[mask]
    img[..., 1][mask] = 0.15 + 0.25 * rings[mask]
    img[..., 2][mask] = 0.10 + 0.15 * rings[mask]


def _depth_of(r, s):
    return np.float32(DEPTH_A + DEPTH_B / (r / s))


def _scene(rng, size):
    """One scene -> (img01 [S,S,3] float32, depth float32)."""
    s = size
    img = _background(rng, s)
    # the TARGET: fully visible, radius (log-uniform) encodes depth
    lo, hi = RADIUS_FRAC
    r = np.exp(rng.uniform(np.log(lo), np.log(hi))) * s
    cy = rng.uniform(r + 2, s - r - 2)
    cx = rng.uniform(r + 2, s - r - 2)
    _draw_target(img, s, r, cy, cx)
    np.clip(img, 0.0, 1.0, out=img)
    return img.astype(np.float32), _depth_of(r, s)


def _anchors_px(s):
    """[9, 2] (y, x) pixel anchors in guidance.INSTRUCTIONS order — the
    same g//4, g//2, 3g//4 fractions models/guidance.py uses for the mask
    focus points (ref:src/model.py:1284-1368), scaled to the image."""
    q, h, t = s // 4, s // 2, s * 3 // 4
    return np.array(
        [[h, h],   # center
         [h, q],   # left
         [h, t],   # right
         [q, h],   # top
         [t, h],   # bottom
         [q, q],   # top-left
         [q, t],   # top-right
         [t, q],   # bottom-left
         [t, t]],  # bottom-right
        np.float32)


AIMED_RADIUS_FRAC = (0.035, 0.11)  # smaller hi so 3 targets fit apart


def _scene_aimed(rng, size, k_targets=3):
    """One AIMED scene -> (img01, depths [9]): k_targets ring disks at
    different depths; the label for instruction i is the depth of the
    target nearest instruction i's anchor — the reference's actual task
    semantics ('how far is the thing I'm aiming at',
    ref:src/model.py:795-928, demo.py --instruction).
    Placement is rejection-sampled so targets don't overlap and every
    anchor has a UNIQUELY nearest target (second-nearest at least 0.08*s
    farther), keeping the label unambiguous."""
    s = size
    anchors = _anchors_px(s)
    lo, hi = AIMED_RADIUS_FRAC
    for _ in range(200):
        rs = np.exp(rng.uniform(np.log(lo), np.log(hi), k_targets)) * s
        cys = rng.uniform(rs + 2, s - rs - 2)
        cxs = rng.uniform(rs + 2, s - rs - 2)
        centers = np.stack([cys, cxs], axis=1)
        # pairwise non-overlap with margin
        d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
        rr = rs[:, None] + rs[None] + 0.03 * s
        if np.any(d[np.triu_indices(k_targets, 1)]
                  < rr[np.triu_indices(k_targets, 1)]):
            continue
        # every anchor: unique nearest target by a margin
        ad = np.linalg.norm(anchors[:, None] - centers[None], axis=-1)
        srt = np.sort(ad, axis=1)
        if np.any(srt[:, 1] - srt[:, 0] < 0.08 * s):
            continue
        break
    else:  # give up on margins, keep the last sample (labels still exact)
        pass
    img = _background(rng, s)
    order = np.argsort(-rs)  # draw big (near) first so overlaps can't hide
    for i in order:
        _draw_target(img, s, rs[i], cys[i], cxs[i])
    np.clip(img, 0.0, 1.0, out=img)
    ad = np.linalg.norm(anchors[:, None] - centers[None], axis=-1)
    nearest = np.argmin(ad, axis=1)
    depths = np.array([_depth_of(rs[j], s) for j in nearest], np.float32)
    return img.astype(np.float32), depths


def gen_procedural_aimed(n, size, seed=0, k_targets=3):
    """[n, S, S, 3] float32 in [0,1] + [n, 9] float32 per-instruction
    depths (guidance.INSTRUCTIONS order)."""
    rng = np.random.RandomState(seed)
    imgs = np.empty((n, size, size, 3), np.float32)
    depths = np.empty((n, 9), np.float32)
    for i in range(n):
        imgs[i], depths[i] = _scene_aimed(rng, size, k_targets)
    return imgs, depths


def gen_procedural_aimed_u8(n, size, seed=0, k_targets=3):
    imgs, depths = gen_procedural_aimed(n, size, seed, k_targets)
    return (imgs * 255.0 + 0.5).astype(np.uint8), depths


def gen_procedural(n, size, seed=0):
    """[n, S, S, 3] float32 in [0,1] + [n] float32 depths."""
    rng = np.random.RandomState(seed)
    imgs = np.empty((n, size, size, 3), np.float32)
    depths = np.empty((n,), np.float32)
    for i in range(n):
        imgs[i], depths[i] = _scene(rng, size)
    return imgs, depths


def gen_procedural_u8(n, size, seed=0):
    """uint8 variant for device staging (4x smaller than float32; /255 and
    the ImageNet normalisation run on the device, in the training step)."""
    imgs, depths = gen_procedural(n, size, seed)
    return (imgs * 255.0 + 0.5).astype(np.uint8), depths


def cached(path, gen, n, size, seed):
    """``gen(n, size, seed)`` -> (u8 or float images, depths), read from the
    npz at ``path`` when it exists, else generated and written there."""
    import os

    if os.path.exists(path):
        with np.load(path) as z:
            return z["u8"], z["depths"]
    imgs, depths = gen(n, size, seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path + ".tmp.npz", u8=imgs, depths=depths)
    os.replace(path + ".tmp.npz", path)
    return imgs, depths


def main(argv=None):
    import sys
    import time

    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    t0 = time.perf_counter()
    imgs, d = gen_procedural(n, 518, 0)
    print(f"{n} scenes @518² in {time.perf_counter() - t0:.1f}s; "
          f"depth range [{d.min():.2f}, {d.max():.2f}]")


if __name__ == "__main__":
    main()
