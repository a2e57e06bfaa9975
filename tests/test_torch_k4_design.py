"""What K4's redesign (csrc/stencil.cu blur_tile_kernel) relies on, held on
the CPU in float32:

  - the plain version's normal and depth weights of a pair of pixels
    (p, q) equal those of (q, p) bit for bit, for every tap offset of both
    passes, at image edges too (where the tap clamps), so each unordered
    pair's weights can be computed once and read from both ends;
  - a serial model of the kernel's tile schedule (the tile plus an r halo,
    the pair weights of each axis indexed by the pair's lower end, taps
    clamped in image coordinates and then indexed in the tile, the mask's
    passthrough, tiles without a masked-in pixel copied) reproduces
    ``filters.bilateral_blur_separable`` bit for bit on planes smaller
    than a tile, one pixel wide, and at radii 1 to 8, in the kernel's
    tiling (32 - 2r pixels wide) and in others.
"""
import numpy as np
import pytest
import torch

from hybrid_rendering_torch.ops import filters

f32 = np.float32


def _planes(H, W, seed, mask="random"):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0, 1, (H, W)).astype(f32)
    n = rs.normal(size=(H, W, 3)).astype(f32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:, : W // 2] = [0, 1, 0]  # a flat half: weights at exactly 1
    depth = rs.uniform(1, 3, (H, W)).astype(f32)
    depth[: H // 3] = 2.0
    m = {"random": rs.uniform(size=(H, W)) > 0.3, "none": np.zeros((H, W), bool),
         "all": np.ones((H, W), bool)}[mask]
    return img, n, depth, m


@pytest.mark.parametrize("radius", [1, 4, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_pair_weights_are_symmetric(radius, axis):
    """For each tap offset o of the pass along `axis`, the weights of p with
    its tap q = clamp(p - o) equal the weights with the centre and the tap
    swapped, bit for bit, at every pixel (the clamped ones at the edges
    included). Both are evaluated at the same positions: PyTorch's CPU pow
    may round a result near the denormal range differently in its vector
    body and its scalar tail, which the card's elementwise powf does not."""
    _, n, depth, _ = (torch.from_numpy(a) for a in _planes(11, 13, seed=radius + axis))
    for o in range(-radius, radius + 1):
        sh = (o, 0) if axis == 0 else (0, o)
        sn, sz = filters.shift2d(n, *sh), filters.shift2d(depth, *sh)
        for power in (32.0, 5.0):
            assert torch.equal(filters.normal_weight(n, sn, power).view(torch.int32),
                               filters.normal_weight(sn, n, power).view(torch.int32))
        for phi in (1.0, 0.3):
            assert torch.equal(filters.depth_weight(depth, sz, phi).view(torch.int32),
                               filters.depth_weight(sz, depth, phi).view(torch.int32))


def _pow(c, power):
    return torch.pow(torch.tensor(c, dtype=torch.float32), power).item()


def _exp(x):
    return torch.exp(torch.tensor(x, dtype=torch.float32)).item()


def _elementwise(fn):
    """`fn` of float32 scalars applied to every element of a tensor."""
    def apply(x, *args):
        flat = x.reshape(-1).tolist()
        return torch.tensor([fn(v, *args) for v in flat], dtype=torch.float32).reshape(x.shape)
    return apply


def _pair(a, b, phi, power):
    """The kernel's blur_pair in float32, with PyTorch's pow and exp."""
    nd = f32(f32(f32(a[0] * b[0]) + f32(a[1] * b[1])) + f32(a[2] * b[2]))
    wn = _pow(min(max(nd, f32(0)), f32(1)), power)
    wz = _exp(f32(-abs(f32(a[3] - b[3]))) / f32(phi))
    return f32(wn), f32(wz)


def tile_model(img, n, depth, mask, radius, tile_w, tile_h, phi=1.0, power=32.0):
    """K4's schedule, block by block, as csrc/stencil.cu blur_tile_kernel
    runs it (every loop of a block serial here)."""
    H, W = img.shape
    r, TW, TH = radius, tile_w, tile_h
    g = [f32(x) for x in filters.gauss_taps(r)]
    out = np.full((H, W), np.nan, f32)

    def clampi(v, hi):
        return min(max(v, 0), hi)

    for by0 in range(0, H, TH):
        for bx0 in range(0, W, TW):
            tw, th = min(TW, W - bx0), min(TH, H - by0)
            if not mask[by0:by0 + th, bx0:bx0 + tw].any():
                out[by0:by0 + th, bx0:bx0 + tw] = img[by0:by0 + th, bx0:bx0 + tw]
                continue
            RW, rx0, ry0, TWr = TW + 2 * r, bx0 - r, by0 - r, TW + r
            G, I, PV, PH, S, V = {}, {}, {}, {}, {}, {}
            cx0, cx1 = max(rx0, 0), min(bx0 + tw + r, W)
            cy0, cy1 = max(ry0, 0), min(by0 + th + r, H)
            for y in range(cy0, cy1):
                for x in range(cx0, cx1):
                    s = (y - ry0) * RW + (x - rx0)
                    G[s] = (*n[y, x], depth[y, x])
                    I[s] = img[y, x]
            for d in range(1, r + 1):  # pairs along y, by their lower end
                for y in range(max(by0 - d, 0), min(by0 + th, H - d)):
                    for x in range(cx0, cx1):
                        s = (y - ry0) * RW + (x - rx0)
                        PV[((d - 1) * (TH + r) + (y - ry0)) * RW + (x - rx0)] = _pair(
                            G[s], G[s + d * RW], phi, power)
                for ty in range(th):  # pairs along x, on the tile's rows
                    for x in range(max(bx0 - d, 0), min(bx0 + tw, W - d)):
                        s = (ty + r) * RW + (x - rx0)
                        PH[((d - 1) * TH + ty) * TWr + (x - rx0)] = _pair(
                            G[s], G[s + d], phi, power)
            for ty in range(th):
                for c in range(cx0 - rx0, cx1 - rx0):
                    q = G[(ty + r) * RW + c]
                    S[ty * RW + c] = _pair(q, q, phi, power)
            for ty in range(th):  # vertical pass
                y = by0 + ty
                for c in range(cx0 - rx0, cx1 - rx0):
                    sum_c = sum_w = f32(0)
                    for i in range(2 * r + 1):
                        q = clampi(y - (i - r), H - 1)
                        wp = (S[ty * RW + c] if q == y
                              else PV[((q - y - 1) * (TH + r) + (y - ry0)) * RW + c] if q > y
                              else PV[((y - q - 1) * (TH + r) + (q - ry0)) * RW + c])
                        w = f32(f32(g[i] * wp[0]) * wp[1])
                        sum_c = f32(sum_c + f32(I[(q - ry0) * RW + c] * w))
                        sum_w = f32(sum_w + w)
                    V[ty * RW + c] = f32(sum_c / max(sum_w, f32(1e-8)))
            for ty in range(th):  # horizontal pass and the mask
                for x in range(bx0, bx0 + tw):
                    res = I[(ty + r) * RW + (x - rx0)]
                    if mask[by0 + ty, x]:
                        sum_c = sum_w = f32(0)
                        for i in range(2 * r + 1):
                            q = clampi(x - (i - r), W - 1)
                            wp = (S[ty * RW + (x - rx0)] if q == x
                                  else PH[((q - x - 1) * TH + ty) * TWr + (x - rx0)] if q > x
                                  else PH[((x - q - 1) * TH + ty) * TWr + (q - rx0)])
                            w = f32(f32(g[i] * wp[0]) * wp[1])
                            sum_c = f32(sum_c + f32(V[ty * RW + (q - rx0)] * w))
                            sum_w = f32(sum_w + w)
                        res = f32(sum_c / max(sum_w, f32(1e-8)))
                    out[by0 + ty, x] = res
    return out


@pytest.mark.parametrize("H,W,radius,tile_w,tile_h,mask", [
    (13, 11, 2, 4, 3, "random"),   # ragged tiles on both axes
    (9, 17, 4, 8, 2, "random"),    # the halo taller than the tile
    (1, 7, 3, 4, 4, "random"),     # one row, tile larger than the plane
    (6, 1, 2, 2, 2, "random"),     # one column
    (10, 12, 8, 4, 4, "random"),   # the largest radius, beyond the plane
    (7, 9, 1, 32, 8, "all"),       # the plane smaller than one tile
    (8, 8, 4, 4, 4, "none"),       # every tile copied
    (11, 53, 4, 24, 8, "random"),  # the kernel's tiling: 32 - 2r wide
    (19, 21, 8, 16, 4, "random"),
])
def test_tile_schedule_matches_plain_version(H, W, radius, tile_w, tile_h, mask, monkeypatch):
    """The plain version's pow and exp are taken element by element here,
    as the card's powf and expf are: PyTorch's CPU pow rounds the same
    argument differently in its vector body and its scalar tail (an ulp),
    which the pair weights' reuse from both ends would show."""
    pow_, exp_ = _elementwise(_pow), _elementwise(_exp)
    monkeypatch.setattr(filters, "normal_weight", lambda c, q, power: pow_(
        torch.clamp(c[..., 0] * q[..., 0] + c[..., 1] * q[..., 1] + c[..., 2] * q[..., 2],
                    0.0, 1.0), power))
    monkeypatch.setattr(filters, "depth_weight",
                        lambda c, q, phi: exp_(-torch.abs(c - q) / phi))
    img, n, depth, m = _planes(H, W, seed=H * W + radius, mask=mask)
    got = tile_model(img, n, depth, m, radius, tile_w, tile_h)
    ref = filters.bilateral_blur_separable(
        *(torch.from_numpy(a) for a in (img, n, depth)), radius=radius,
        mask=torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
