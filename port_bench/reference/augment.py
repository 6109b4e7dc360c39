"""Plain device augmentations of DCT planes, computed on decoded pixels.

The two augment chains the training cells drive, written from their
descriptions and computed the straightforward way: every 8x8 block of
coefficients is decoded to pixels (orthonormal DCT-II, JPEG's level-shifted
convention), the crop and resize is one interpolation matrix per image and
axis applied to the pixel planes, the flip reverses pixel columns, the
photometric change is the per-pixel linear map, and the result is encoded
back to blocks.  Imports nothing of the system under test.

The random draws are made here too, from the generator the benchmark hands
to the program, in the order and with the distributions the augment
documents (`sample_detection_v3`, `sample_classification_v2`).  The crop's
coordinates are float32 values, each multiply-add rounded once (`_fma`), as
the augment states them: a nearest-neighbour sample that lies on a
half-pixel tie then rounds the one way the augment defines.  Pixel
arithmetic runs in `dtype`.

Detection v3: photometric (brightness U(+-32) and contrast, saturation
U(0.5, 1.5) and hue U(+-36 deg), each with p = 0.5) -> expand by f ~ U(1, 4)
with p = 0.5 onto a mean-colour canvas, a min-IoU crop from 8 trials of
side shares U(0.3, 1) with aspect ratio in [0.5, 2] (the full canvas with
p = 0.3 or when no trial fits) -> resize to 304 px with one of 5
interpolation kernels -> horizontal flip with p = 0.5; boxes follow, are
kept where their centre stays inside, clipped, and dropped when empty.

Classification v2: a crop of area share U(0.35, 1) and aspect ratio
exp(U(log 0.75, log 1.333)) (the full frame with p = 0.2) at a uniform
position, resized bilinearly to 224 px, a fair flip, then the photometric
change.
"""

from __future__ import annotations

import math

import torch

IOU_BOUNDS = (-1.0, 0.1, 0.3, 0.5, 0.7, 0.9)
BACKGROUND = (123.0, 117.0, 104.0)
BILINEAR, NEAREST, CUBIC, AREA, LANCZOS4 = range(5)


# --------------------------------------------------------------------------
# draws
# --------------------------------------------------------------------------

def _u(g, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=g) * (hi - lo) + lo


def _b(g, p, shape):
    return torch.rand(shape, generator=g) < p


def sample_photometric(g, B):
    bright = _u(g, (B,), -32.0, 32.0) * _b(g, 0.5, (B,))
    contrast = torch.where(_b(g, 0.5, (B,)), _u(g, (B,), 0.5, 1.5), 1.0)
    sat = torch.where(_b(g, 0.5, (B,)), _u(g, (B,), 0.5, 1.5), 1.0)
    hmax = 36.0 * math.pi / 180.0
    hue = torch.where(_b(g, 0.5, (B,)), _u(g, (B,), -hmax, hmax), 0.0)
    return {"bright": bright, "contrast": contrast, "sat": sat, "hue": hue}


def sample_detection_v3(g, B, h8, w8, trials=8):
    d = {"photo": sample_photometric(g, B)}
    H, W = h8 * 8.0, w8 * 8.0
    do = _b(g, 0.5, (B,))
    f = torch.where(do, _u(g, (B,), 1.0, 4.0), 1.0)
    d.update(f=f, py=_u(g, (B,)) * (f * H - H), px=_u(g, (B,)) * (f * W - W),
             bound=torch.tensor(IOU_BOUNDS)[torch.randint(0, 6, (B,), generator=g)],
             s_h=_u(g, (B, trials), 0.3, 1.0), s_w=_u(g, (B, trials), 0.3, 1.0),
             u=_u(g, (B, trials, 2)), flip=_b(g, 0.5, (B,)), ident=_b(g, 0.3, (B,)),
             mode=torch.randint(0, 5, (B,), generator=g))
    return d


def sample_classification_v2(g, B, h8, w8):
    H, W = h8 * 8.0, w8 * 8.0
    area = _u(g, (B,), 0.35, 1.0)
    ar = torch.exp(_u(g, (B,), math.log(0.75), math.log(1.333)))
    ident = _b(g, 0.2, (B,))
    ch = torch.where(ident, H, torch.clamp_max(torch.sqrt(area / ar) * H, H))
    cw = torch.where(ident, W, torch.clamp_max(torch.sqrt(area * ar) * W, W))
    d = {"y0": _u(g, (B,)) * (H - ch), "x0": _u(g, (B,)) * (W - cw), "ch": ch, "cw": cw,
         "flip": _b(g, 0.5, (B,))}
    d["photo"] = sample_photometric(g, B)
    return d


# --------------------------------------------------------------------------
# pixels <-> blocks
# --------------------------------------------------------------------------

def dct_matrix(dtype=torch.float64, device="cpu"):
    """C[u, x] = c(u)/2 cos((2x + 1) u pi / 16), orthonormal rows."""
    x = torch.arange(8, dtype=torch.float64)
    c = 0.5 * torch.cos((2 * x[None, :] + 1) * x[:, None] * math.pi / 16)
    c[0] /= math.sqrt(2.0)
    return c.to(device=device, dtype=dtype)


def to_pixels(blocks, dtype):
    """(B, H8, W8, 64 k) coefficients -> (B, k, 8 H8, 8 W8) level-shifted pixels."""
    B, H8, W8, ch = blocks.shape
    k = ch // 64
    c = dct_matrix(dtype, blocks.device)
    f = blocks.to(dtype).reshape(B, H8, W8, k, 8, 8)
    p = torch.einsum("ux,bijkuv,vy->bkixjy", c, f, c)
    return p.reshape(B, k, H8 * 8, W8 * 8)


def to_blocks(pixels):
    """(B, k, 8 H8, 8 W8) pixels -> (B, H8, W8, 64 k) coefficients."""
    B, k, H, W = pixels.shape
    c = dct_matrix(pixels.dtype, pixels.device)
    p = pixels.reshape(B, k, H // 8, 8, W // 8, 8)
    f = torch.einsum("ux,bkixjy,vy->bijkuv", c, p, c)
    return f.reshape(B, H // 8, W // 8, k * 64)


# --------------------------------------------------------------------------
# resampling
# --------------------------------------------------------------------------

def _cubic(x, a=-0.75):
    ax = x.abs()
    near = ((a + 2) * ax - (a + 3)) * ax * ax + 1
    far = ((a * ax - 5 * a) * ax + 8 * a) * ax - 4 * a
    return torch.where(ax <= 1, near, torch.where(ax < 2, far, 0))


def _lanczos4(x):
    px = math.pi * x
    small = x.abs() < 1e-7
    s = torch.where(small, 1.0, torch.sin(px) / torch.where(small, 1.0, px))
    sa = torch.where(small, 1.0, torch.sin(px / 4) / torch.where(small, 1.0, px / 4))
    return torch.where(x.abs() < 4, s * sa, 0)


def _fma(a, b, c):
    """float32 a * b + c rounded once (the float64 product of two float32
    values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def interp_matrix(src, dst, start, length, mode, clamp, dtype):
    """(B, dst, src) weights resampling [start, start + length) of a `src`
    pixel axis to `dst` pixels (pixel centres at +0.5), and the (B, dst)
    mass left for the background.  With `clamp` (the crop lies inside the
    source) samples and taps are held at the edge; else taps outside the
    source weigh nothing.  Kernels: bilinear, nearest (round half to even),
    cubic (a = -0.75), area (overlap share) and Lanczos-4 (normalized)."""
    B = start.shape[0]
    dev = start.device
    start, length = start.float()[:, None], length.float()[:, None]
    clamp, mode = clamp[:, None], mode[:, None]
    hi = src - 1.0
    o = torch.arange(dst, dtype=torch.float32, device=dev)[None]
    step = length / dst
    # sample positions and tap indices in float32; weights in `dtype`
    s = _fma(o + 0.5, step, start) - 0.5
    s_cl = torch.where(clamp, s.clamp(0, hi), s)
    W = torch.zeros(B, dst, src, dtype=dtype, device=dev)

    def add(idx, w, sel):
        idx = torch.where(clamp, idx.clamp(0, hi), idx)
        ok = (idx >= 0) & (idx <= hi) & sel
        W.scatter_add_(2, idx.clamp(0, hi).long()[..., None],
                       torch.where(ok, w.to(dtype), 0)[..., None])

    i0 = torch.floor(s_cl)
    fr = (s_cl - i0).to(dtype)
    add(i0, 1 - fr, mode == BILINEAR)
    add(i0 + 1, fr, mode == BILINEAR)
    add(torch.round(s_cl), torch.ones_like(fr), mode == NEAREST)
    r0 = torch.floor(s)
    rf = (s - r0).to(dtype)
    for off in (-1, 0, 1, 2):
        add(r0 + off, _cubic(rf - off), mode == CUBIC)
    lz = torch.stack([_lanczos4(rf - off) for off in range(-3, 5)], -1)
    lz = lz / lz.sum(-1, keepdim=True)
    for j, off in enumerate(range(-3, 5)):
        add(r0 + off, lz[..., j], mode == LANCZOS4)
    b = _fma(o, step, start)
    e = b + step
    b = torch.where(clamp, b.clamp(0, src), b)
    e = torch.where(clamp, e.clamp(0, src), e)
    cells = torch.arange(src, dtype=torch.float32, device=dev)
    cover = (torch.minimum(e[..., None], cells + 1) - torch.maximum(b[..., None], cells)).clamp_min(0)
    area = (cover / (e - b).clamp_min(1e-12)[..., None]).to(dtype)
    W = torch.where((mode == AREA)[..., None], area, W)
    return W, 1 - W.sum(-1)


def crop_resize(pixels, y0, x0, h, w, out, mode, background):
    """(B, k, H, W) pixels -> (B, k, out, out): the crop [y0, y0 + h) x
    [x0, x0 + w) resized, the parts outside the source filled with
    `background` (one level-shifted value per plane)."""
    B, k, H, W = pixels.shape
    dt = pixels.dtype
    y0, x0, h, w = (t.float() for t in (y0, x0, h, w))
    clamp_y = (y0 >= 0) & (y0 + h <= H)
    clamp_x = (x0 >= 0) & (x0 + w <= W)
    Wy, ry = interp_matrix(H, out, y0, h, mode, clamp_y, dt)
    Wx, rx = interp_matrix(W, out, x0, w, mode, clamp_x, dt)
    res = torch.einsum("boh,bkhw,bpw->bkop", Wy, pixels, Wx)
    mass = 1 - (1 - ry)[:, :, None] * (1 - rx)[:, None, :]
    bg = torch.tensor(background, dtype=dt, device=pixels.device)
    return res + bg[None, :, None, None] * mass[:, None]


def photometric(yp, cp, d):
    """Brightness and contrast on luma, contrast then hue rotation and
    saturation on (Cb, Cr), all on level-shifted pixels."""
    dt = yp.dtype
    a = d["contrast"].to(dt)[:, None, None, None]
    yp = yp * a + d["bright"].to(dt)[:, None, None, None]
    cp = cp * a
    h = d["hue"].to(dt)[:, None, None]
    s = d["sat"].to(dt)[:, None, None]
    cb, cr = cp[:, 0], cp[:, 1]
    cp = torch.stack([s * (torch.cos(h) * cb - torch.sin(h) * cr),
                      s * (torch.sin(h) * cb + torch.cos(h) * cr)], 1)
    return yp, cp


def _flip(p, flip):
    return torch.where(flip[:, None, None, None], p.flip(-1), p)


def _box_iou_max(x0, y0, w, h, gt, mask):
    """(B, T) max IoU of T patches with each image's valid GT."""
    g = gt[:, None]
    ix = (torch.minimum(x0[..., None] + w[..., None], g[..., 3]) - torch.maximum(g[..., 1], x0[..., None])).clamp_min(0)
    iy = (torch.minimum(y0[..., None] + h[..., None], g[..., 4]) - torch.maximum(g[..., 2], y0[..., None])).clamp_min(0)
    inter = ix * iy
    union = (w * h)[..., None] + (g[..., 3] - g[..., 1]) * (g[..., 4] - g[..., 2]) - inter
    ious = torch.where((union > 0) & mask[:, None], inter / torch.where(union > 0, union, 1), 0)
    return ious.amax(-1).clamp_min(0)


def _boxes_after(gt, mask, rx, ry, sx, sy, flip, out):
    cls = gt[..., 0]
    x0, x1 = (gt[..., 1] - rx) * sx, (gt[..., 3] - rx) * sx
    y0, y1 = (gt[..., 2] - ry) * sy, (gt[..., 4] - ry) * sy
    f = flip[:, None]
    x0, x1 = torch.where(f, out - x1, x0), torch.where(f, out - x0, x1)
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    keep = mask & (cx >= 0) & (cx < out) & (cy >= 0) & (cy < out)
    x0, x1, y0, y1 = (v.clamp(0, out - 1) for v in (x0, x1, y0, y1))
    keep = keep & (x1 > x0) & (y1 > y0)
    boxes = torch.stack([cls, x0, y0, x1, y1], -1)
    return torch.where(keep[..., None], boxes, 0), keep


def _dc_colour(bg):
    r, g, b = bg
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return y - 128, cb - 128, cr - 128


def detection_v3(y, cbcr, gt, mask, d, out_blocks=38, dtype=torch.float64):
    """The detection chain on (B, H8, W8, 64) and (B, H8/2, W8/2, 128)
    source planes and (B, G, 5) pixel boxes -> (y, cbcr, gt, mask) in the
    (8 out_blocks)-px frame."""
    dev = y.device
    d = _to(d, dev)
    H, W = y.shape[1] * 8.0, y.shape[2] * 8.0
    out = out_blocks * 8
    yp, cp = photometric(to_pixels(y, dtype), to_pixels(cbcr, dtype), d["photo"])
    gt = gt.to(dtype)
    f, py, px = d["f"].float(), d["py"].float(), d["px"].float()
    ch, cw = f * H, f * W
    s_h, s_w = d["s_h"].float(), d["s_w"].float()
    ph, pw = s_h * ch[:, None], s_w * cw[:, None]
    u = d["u"].float()
    cy0 = _fma(u[..., 0], _fma(-s_h, ch[:, None], ch[:, None]), -py[:, None])
    cx0 = _fma(u[..., 1], _fma(-s_w, cw[:, None], cw[:, None]), -px[:, None])
    ar_ok = (pw / ph >= 0.5) & (pw / ph <= 2.0)
    ious = _box_iou_max(cx0.to(dtype), cy0.to(dtype), pw.to(dtype), ph.to(dtype), gt, mask)
    bound = d["bound"].to(dtype)[:, None]
    ok = ar_ok & ((ious >= bound) | (bound < 0) | ~mask.any(-1)[:, None])
    first = ok.to(torch.uint8).argmax(-1)
    best = torch.where(ar_ok, ious, -1.0).argmax(-1)
    pick = torch.where(ok.any(-1), first, best)[:, None]
    full = ~ar_ok.any(-1) | d["ident"]
    ry0 = torch.where(full, -py, cy0.gather(1, pick)[:, 0])
    rx0 = torch.where(full, -px, cx0.gather(1, pick)[:, 0])
    hh = torch.where(full, ch, ph.gather(1, pick)[:, 0])
    ww = torch.where(full, cw, pw.gather(1, pick)[:, 0])
    bg_y, bg_cb, bg_cr = _dc_colour(BACKGROUND)
    mode, flip = d["mode"], d["flip"]
    yo = crop_resize(yp, ry0, rx0, hh, ww, out, mode, (bg_y,))
    co = crop_resize(cp, ry0 / 2, rx0 / 2, hh / 2, ww / 2, out // 2, mode, (bg_cb, bg_cr))
    yo, co = _flip(yo, flip), _flip(co, flip)
    rx0, ry0, ww, hh = (t.to(dtype)[:, None] for t in (rx0, ry0, ww, hh))
    boxes, keep = _boxes_after(gt, mask, rx0, ry0, out / ww, out / hh, flip, out)
    return to_blocks(yo), to_blocks(co), boxes, keep


def classification_v2(y, cbcr, d, out_blocks=28, dtype=torch.float64):
    """The classification chain: crop + bilinear resize, flip, photometric."""
    dev = y.device
    d = _to(d, dev)
    out = out_blocks * 8
    y0, x0, ch, cw = (d[k].float() for k in ("y0", "x0", "ch", "cw"))
    mode = torch.full_like(d["flip"], BILINEAR, dtype=torch.long)
    yo = crop_resize(to_pixels(y, dtype), y0, x0, ch, cw, out, mode, (0.0,))
    co = crop_resize(to_pixels(cbcr, dtype), y0 / 2, x0 / 2, ch / 2, cw / 2, out // 2, mode,
                     (0.0, 0.0))
    yo, co = _flip(yo, d["flip"]), _flip(co, d["flip"])
    yo, co = photometric(yo, co, d["photo"])
    return to_blocks(yo), to_blocks(co)


def _to(d, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev)) for k, v in d.items()}
