"""The reference path tracer: the radiance of a batch of samples, each a
(slot, sample) pair, by the forward megakernel's semantics.

Frozen copy, cut to what the configurations use (no textures, no
next-event estimation, no depth of field, the per-thread mesh walk), of
`trace_tiles_reference`, `_nearest_hit`, `traverse_reference`,
`leaf_tests` and the ray-primitive functions of
pathtracer_tpu_torch/render/megakernel.py at commit 7dc6265. The float32
operations are the same and in the same order, so that a sample traces
the path the card traces; what changed: the batch is any set of samples
(the sample number, the tile key and the slot's element index are
per-ray tensors), a group is walked on the reference's own BVH (ptbench/
ref/bvh.py; only the order of the leaves differs, which changes a result
only where two triangles tie on t exactly), and `dtype` runs the whole
path in another precision (the control of the benchmark's check).
"""
from __future__ import annotations

import math

import torch

from .hashrng import uniform
from .scene import GROUP, LEAF, TYPES, RefScene

BIG = 1e30
PLANE, SPHERE, CYLINDER, BOX = (TYPES[k] for k in
                                ("plane", "sphere", "cylinder", "box"))
LEAF_CHUNK = 1 << 19


def _mat12_point(m, x, y, z):
    return (m[0] * x + m[1] * y + m[2] * z + m[3],
            m[4] * x + m[5] * y + m[6] * z + m[7],
            m[8] * x + m[9] * y + m[10] * z + m[11])


def _mat12_vec(m, x, y, z):
    return (m[0] * x + m[1] * y + m[2] * z,
            m[4] * x + m[5] * y + m[6] * z,
            m[8] * x + m[9] * y + m[10] * z)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize(x, y, z):
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _axis_slab(o, d, mn, mx, eps):
    use = torch.abs(d) >= eps
    d_safe = torch.where(use, d, 1.0)
    t1 = torch.where(use, (mn - o) / d_safe, (mn - o) * BIG)
    t2 = torch.where(use, (mx - o) / d_safe, (mx - o) * BIG)
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def _plane_t(oy, dy, eps):
    ok = torch.abs(dy) > eps
    t = -oy / torch.where(ok, dy, 1.0)
    return torch.where(ok & (t > eps), t, BIG)


def _sphere_t(ox, oy, oz, dx, dy, dz, eps):
    a = dx * dx + dy * dy + dz * dz
    t_mid = -(ox * dx + oy * dy + oz * dz) / a
    mx = ox + dx * t_mid
    my = oy + dy * t_mid
    mz = oz + dz * t_mid
    perp2 = mx * mx + my * my + mz * mz
    ok = perp2 < 1.0
    dt = torch.sqrt(torch.where(ok, (1.0 - perp2) / a, 0.0))
    t1 = t_mid - dt
    t2 = t_mid + dt
    return torch.minimum(torch.where(ok & (t1 > eps), t1, BIG),
                         torch.where(ok & (t2 > eps), t2, BIG))


def _cylinder_t(ox, oy, oz, dx, dy, dz, min_y, max_y, eps):
    a = dx * dx + dz * dz
    ok_a = torch.abs(a) >= eps
    a_safe = torch.where(ok_a, a, 1.0)
    t_mid = -(ox * dx + oz * dz) / a_safe
    mx = ox + dx * t_mid
    mz = oz + dz * t_mid
    perp2 = mx * mx + mz * mz
    ok = ok_a & (perp2 <= 1.0)
    dt = torch.sqrt(torch.where(ok, (1.0 - perp2) / a_safe, 0.0))
    t0 = t_mid - dt
    t1 = t_mid + dt
    y0 = oy + t0 * dy
    y1 = oy + t1 * dy
    v0 = ok & (y0 > min_y) & (y0 < max_y) & (t0 > eps)
    v1 = ok & (y1 > min_y) & (y1 < max_y) & (t1 > eps)
    return torch.minimum(torch.where(v0, t0, BIG), torch.where(v1, t1, BIG))


def _box_t(ox, oy, oz, dx, dy, dz, eps):
    x1, x2 = _axis_slab(ox, dx, -1.0, 1.0, eps)
    y1, y2 = _axis_slab(oy, dy, -1.0, 1.0, eps)
    z1, z2 = _axis_slab(oz, dz, -1.0, 1.0, eps)
    tmin = torch.maximum(torch.maximum(x1, y1), z1)
    tmax = torch.minimum(torch.minimum(x2, y2), z2)
    ok = tmin <= tmax
    return torch.minimum(torch.where(ok & (tmin > eps), tmin, BIG),
                         torch.where(ok & (tmax > eps), tmax, BIG))


def _schlick(cx, cy, cz, nx, ny, nz, n1, n2):
    cos = _dot(cx, cy, cz, nx, ny, nz)
    n = n1 / n2
    sin2t = (n * n) * (1.0 - cos * cos)
    tir = (n1 > n2) & (sin2t > 1.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2t, min=0.0))
    cos_eff = torch.where(n1 > n2, cos_t, cos)
    temp = (n1 - n2) / (n1 + n2)
    r0 = temp * temp
    m = 1.0 - cos_eff
    m2 = m * m
    res = r0 + (1.0 - r0) * (m2 * m2 * m)
    return torch.where(tir, 1.0, res)


def _refract(cx, cy, cz, nx, ny, nz, n1, n2):
    cos_i = _dot(cx, cy, cz, nx, ny, nz)
    ratio = n1 / n2
    sin2t = (ratio * ratio) * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2t, min=0.0))
    k = ratio * cos_i - cos_t
    ok = sin2t <= 1.0
    return (torch.where(ok, nx * k - cx * ratio, 0.0),
            torch.where(ok, ny * k - cy * ratio, 0.0),
            torch.where(ok, nz * k - cz * ratio, 0.0))


def _object_t(code, m, eps, ox, oy, oz, dx, dy, dz):
    """t of a primitive (row m) for the world rays; a plane transforms only
    its y row."""
    if code == PLANE:
        return _plane_t(m[4] * ox + m[5] * oy + m[6] * oz + m[7],
                        m[4] * dx + m[5] * dy + m[6] * dz, eps)
    loc = (*_mat12_point(m, ox, oy, oz), *_mat12_vec(m, dx, dy, dz))
    if code == SPHERE:
        return _sphere_t(*loc, eps)
    if code == CYLINDER:
        return _cylinder_t(*loc[:6], m[32], m[33], eps)
    if code == BOX:
        return _box_t(*loc, eps)
    raise ValueError(f"object type {code} is not a primitive")


def _leaf_tests(tri, start, leaf_size, eps, ox, oy, oz, dx, dy, dz):
    """Dual-basis tests of the leaf's slots: (closest valid t per ray, BIG
    where none; its slot, the lowest on ties; u, v there)."""
    ar = torch.arange(leaf_size, device=start.device)
    rows = tri[start[:, None] + ar]

    def c(i):
        return rows[..., i]

    ox, oy, oz, dx, dy, dz = (a[:, None] for a in (ox, oy, oz, dx, dy, dz))
    pxx = ox - c(0)
    pyy = oy - c(1)
    pzz = oz - c(2)
    den = dx * c(3) + dy * c(4) + dz * c(5)
    num_t = -(pxx * c(3) + pyy * c(4) + pzz * c(5))
    den_ok = torch.abs(den) >= eps
    f = 1.0 / torch.where(den_ok, den, 1.0)
    t = num_t * f
    hx = pxx + t * dx
    hy = pyy + t * dy
    hz = pzz + t * dz
    u = hx * c(6) + hy * c(7) + hz * c(8)
    v = hx * c(9) + hy * c(10) + hz * c(11)
    valid = (den_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps))
    tv = torch.where(valid, t, BIG)
    tw = tv.min(dim=1).values
    k = torch.where(tv == tw[:, None], ar, leaf_size).min(dim=1).values
    pick = k[:, None]
    return (tw, start + k, u.gather(1, pick).squeeze(1),
            v.gather(1, pick).squeeze(1))


def _slab_hit(nd, ray, bt, eps):
    ox, oy, oz, _, _, _, ivx, ivy, ivz = ray
    ax1 = (nd[:, 0] - ox) * ivx
    ax2 = (nd[:, 4] - ox) * ivx
    ay1 = (nd[:, 1] - oy) * ivy
    ay2 = (nd[:, 5] - oy) * ivy
    az1 = (nd[:, 2] - oz) * ivz
    az2 = (nd[:, 6] - oz) * ivz
    tmin = torch.maximum(
        torch.maximum(torch.minimum(ax1, ax2), torch.minimum(ay1, ay2)),
        torch.minimum(az1, az2))
    tmax = torch.minimum(
        torch.minimum(torch.maximum(ax1, ax2), torch.maximum(ay1, ay2)),
        torch.maximum(az1, az2))
    return (tmin <= tmax) & (tmax > eps) & (tmin < bt)


def _walk(sc: RefScene, eps, t_max, root, end, tox, toy, toz,
          tdx, tdy, tdz, active, bt0):
    """Each active ray's own stackless walk of nodes [root, end): on a hit
    the next node (a leaf's slots tested, a closer winner kept), on a miss
    the node's exit. Returns (t, smooth normal xyz, color rgb, slot), t
    bt0 and the rest 0 (slot -1) where no triangle won."""
    bt = bt0.clone()
    win = torch.full(bt.shape, -1, dtype=torch.int64, device=bt.device)
    wu = torch.zeros_like(bt)
    wv = torch.zeros_like(bt)
    rid = torch.nonzero(active).squeeze(1)
    ray = [a[rid] for a in (tox, toy, toz, tdx, tdy, tdz)]
    for d in ray[3:6]:
        ok = torch.abs(d) >= eps
        ray.append(torch.where(ok, 1.0 / torch.where(ok, d, 1.0), BIG))
    idx = torch.full_like(rid, root)
    while rid.numel():
        nd = sc.nodes[idx]
        start, exit_ = sc.links[idx].unbind(1)
        hit = _slab_hit(nd, ray, bt[rid], eps)
        at_leaf = torch.nonzero(hit & (start >= 0)).squeeze(1)
        for i in range(0, at_leaf.numel(), LEAF_CHUNK):
            li = at_leaf[i:i + LEAF_CHUNK]
            r = rid[li]
            tw, slot, u, v = _leaf_tests(
                sc.tris, start[li], LEAF, eps,
                *(a[li] for a in ray[:6]))
            won = (tw < bt[r]) & (tw < t_max)
            r = r[won]
            bt[r] = tw[won]
            win[r] = slot[won]
            wu[r] = u[won]
            wv[r] = v[won]
        idx = torch.where(hit, idx + 1, exit_)
        keep = torch.nonzero(idx < end).squeeze(1)
        if keep.numel() < rid.numel():
            rid, idx = rid[keep], idx[keep]
            ray = [a[keep] for a in ray]
    out = [bt] + [torch.zeros_like(bt) for _ in range(6)]
    r = torch.nonzero(win >= 0).squeeze(1)
    if r.numel():
        row = sc.shade[win[r]]
        u, v = wu[r], wv[r]
        for k in range(3):
            out[1 + k][r] = row[:, k] + row[:, 3 + k] * u + row[:, 6 + k] * v
            out[4 + k][r] = row[:, 9 + k]
    return (*out, win)


def nearest_hit(sc: RefScene, eps, t_max, ox, oy, oz, dx, dy, dz,
                active):
    """Every object's test in table order, the winner replaced on a
    strictly smaller t (a group: its object-space box against the best t so
    far, then its walk); then the winner's object-space ray. Returns (t,
    winner, local ray, on_tri, slot, smooth normal, triangle color)."""
    best_t = torch.full_like(ox, BIG)
    w = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    on_tri = torch.zeros_like(ox, dtype=torch.bool)
    tri_slot = torch.full_like(w, -1)
    tri_nrm = [torch.zeros_like(ox) for _ in range(3)]
    tri_col = [torch.zeros_like(ox) for _ in range(3)]
    for j, code in enumerate(sc.types):
        m = sc.obj[j]
        if code != GROUP:
            t_j = _object_t(code, m, eps, ox, oy, oz, dx, dy, dz)
            g_tri = None
        else:
            loc = (*_mat12_point(m, ox, oy, oz), *_mat12_vec(m, dx, dy, dz))
            x1, x2 = _axis_slab(loc[0], loc[3], m[34], m[37], eps)
            y1, y2 = _axis_slab(loc[1], loc[4], m[35], m[38], eps)
            z1, z2 = _axis_slab(loc[2], loc[5], m[36], m[39], eps)
            gtmin = torch.maximum(torch.maximum(x1, y1), z1)
            gtmax = torch.minimum(torch.minimum(x2, y2), z2)
            pre = active & (gtmin <= gtmax) & (gtmax > eps) & (gtmin < best_t)
            root, end = sc.groups[j]
            t_j, *g_tri, g_slot = _walk(sc, eps, t_max, root, end,
                                        *loc, pre, best_t)
        closer = t_j < best_t
        best_t = torch.where(closer, t_j, best_t)
        w = torch.where(closer, j, w)
        on_tri = torch.where(closer, g_tri is not None, on_tri)
        if g_tri is not None:
            tri_slot = torch.where(closer, g_slot, tri_slot)
            tri_nrm = [torch.where(closer, a, b)
                       for a, b in zip(g_tri[:3], tri_nrm)]
            tri_col = [torch.where(closer, a, b)
                       for a, b in zip(g_tri[3:], tri_col)]
    won = best_t < BIG
    rows = sc.obj_table.to(ox.dtype)[torch.where(won, w, 0)].unbind(-1)
    loc = [torch.where(won, a, b) for a, b in zip(
        (*_mat12_point(rows, ox, oy, oz), *_mat12_vec(rows, dx, dy, dz)),
        (ox, oy, oz, dx, dy, dz))]
    return best_t, w, loc, on_tri, tri_slot, tri_nrm, tri_col


def radiance(sc: RefScene, render: dict, fx, fy, key, elem, u_elem, n,
             dtype=torch.float32, counts: dict = None, tri_color=None):
    """The radiance (r, g, b) of one sample per entry: pixel (fx, fy), tile
    key, element index of the slot (the jitter's draws) and of its shared
    draws (`u_elem`), sample number `n` within its launch. `render` holds
    epsilon, t_max, max_bounces and max_effective_bounces. `counts`, when
    given, gains the work: "samples", "bounces" (rays alive at a bounce's
    intersection) and "hits" (those that hit something). `tri_color`
    ([slots of sc.shade, 3], e.g. a tensor autograd follows) replaces the
    shading table's triangle colors, gathered by the winning slot."""
    f32 = dtype
    cam = sc.cam
    if cam[15] != 0.0:
        raise ValueError("the reference renders without depth of field")
    # the node links stay integers (sc.links) in any precision
    sc = sc._replace(obj_table=sc.obj_table.to(dtype), nodes=sc.nodes.to(dtype),
                     tris=sc.tris.to(dtype), shade=sc.shade.to(dtype))
    types = torch.tensor(sc.types, dtype=torch.int64, device=fx.device)
    pixel_size, half_w, half_h = cam[12:15]
    oxw, oyw, ozw = cam[3], cam[7], cam[11]
    eps, t_max = render["epsilon"], render["t_max"]
    fx = fx.to(f32)
    fy = fy.to(f32)
    one = torch.ones_like(fx)
    glass = torch.full_like(fx, 1.5)

    def u(did, b=None):
        return uniform(key, elem if did < 2 else u_elem, did, n, b).to(f32)

    jx, jy = u(0), u(1)
    x_off = pixel_size * (fx + jx)
    y_off = pixel_size * (fy + jy)
    pxw, pyw, pzw = _mat12_point(cam, half_w - x_off, half_h - y_off, -1.0)
    dx, dy, dz = _normalize(pxw - oxw, pyw - oyw, pzw - ozw)
    ox = torch.full_like(fx, oxw)
    oy = torch.full_like(fx, oyw)
    oz = torch.full_like(fx, ozw)

    mask_r, mask_g, mask_b = one, one, one
    srr = torch.zeros_like(fx)
    srg = torch.zeros_like(fx)
    srb = torch.zeros_like(fx)
    alive = torch.ones_like(fx, dtype=torch.bool)
    inside = torch.zeros_like(alive)
    n_hits = torch.zeros_like(fx, dtype=torch.int32)
    eff = torch.zeros_like(n_hits)
    if counts is not None:
        counts["samples"] = counts.get("samples", 0) + fx.numel()
    for b in range(render["max_bounces"]):
        n_alive = int(alive.sum())
        if not n_alive:
            break
        if counts is not None:
            counts["bounces"] = counts.get("bounces", 0) + n_alive
        (best_t, w, (l_ox, l_oy, l_oz, l_dx, l_dy, l_dz), on_tri, tri_slot,
         tri_nrm, tri_col) = nearest_hit(sc, eps, t_max, ox, oy,
                                         oz, dx, dy, dz, alive)
        if tri_color is not None:
            tri_col = torch.index_select(
                tri_color, 0, torch.clamp(tri_slot, min=0)).to(f32).unbind(1)
        hit_ok = best_t < t_max
        t = torch.clamp(best_t, max=t_max)
        wrow = sc.obj_table[w]
        col_r = torch.where(on_tri, tri_col[0], wrow[:, 24])
        col_g = torch.where(on_tri, tri_col[1], wrow[:, 25])
        col_b = torch.where(on_tri, tri_col[2], wrow[:, 26])
        emi_r = torch.where(on_tri, 0.0, wrow[:, 27])
        emi_g = torch.where(on_tri, 0.0, wrow[:, 28])
        emi_b = torch.where(on_tri, 0.0, wrow[:, 29])
        refr, refl = wrow[:, 30], wrow[:, 31]
        w_type = types[w]
        lx = l_ox + l_dx * t
        ly = l_oy + l_dy * t
        lz = l_oz + l_dz * t
        dist = lx * lx + lz * lz
        top = (dist < 1.0) & (ly >= wrow[:, 33] - eps)
        bot = (dist < 1.0) & (ly <= wrow[:, 32] + eps)
        cyl_nx = torch.where(top | bot, 0.0, lx)
        cyl_ny = torch.where(top, 1.0, torch.where(bot, -1.0, 0.0)).to(
            lx.dtype)
        cyl_nz = torch.where(top | bot, 0.0, lz)
        ax, ay, az = torch.abs(lx), torch.abs(ly), torch.abs(lz)
        maxc = torch.maximum(torch.maximum(ax, ay), az)
        sel_x = maxc == ax
        sel_y = (~sel_x) & (maxc == ay)
        box_nx = torch.where(sel_x, lx, 0.0)
        box_ny = torch.where(sel_y, ly, 0.0)
        box_nz = torch.where(sel_x | sel_y, 0.0, lz)
        is_plane = w_type == PLANE
        is_cyl = w_type == CYLINDER
        is_box = w_type == BOX
        nlx = torch.where(on_tri, tri_nrm[0], torch.where(
            is_plane, 0.0, torch.where(
                is_cyl, cyl_nx, torch.where(is_box, box_nx, lx))))
        nly = torch.where(on_tri, tri_nrm[1], torch.where(
            is_plane, 1.0, torch.where(
                is_cyl, cyl_ny, torch.where(is_box, box_ny, ly))))
        nlz = torch.where(on_tri, tri_nrm[2], torch.where(
            is_plane, 0.0, torch.where(
                is_cyl, cyl_nz, torch.where(is_box, box_nz, lz))))
        invt = [wrow[:, 12 + k] for k in range(12)]
        nx, ny, nz = _normalize(*_mat12_vec(invt, nlx, nly, nlz))
        ex, ey, ez = -dx, -dy, -dz
        flip = _dot(ex, ey, ez, nx, ny, nz) < 0.0
        nx = torch.where(flip, -nx, nx)
        ny = torch.where(flip, -ny, ny)
        nz = torch.where(flip, -nz, nz)

        u_refl, u_schl, u1, u2 = (u(did, b) for did in (2, 3, 4, 5))
        wx = ox + dx * t
        wy = oy + dy * t
        wz = oz + dz * t
        do_reflect = (refl != 0.0) & (u_refl < refl)
        thin = (~do_reflect) & (refr == -1.0)
        sch_thin = _schlick(ex, ey, ez, nx, ny, nz, one, glass)
        thin_pass = thin & (sch_thin < u_schl)
        thin_reflect = thin & ~(sch_thin < u_schl)
        solid = (~do_reflect) & (~thin) & (refr != 1.0)
        outside = ~inside
        sch = torch.where(outside,
                          _schlick(ex, ey, ez, nx, ny, nz, one, refr),
                          _schlick(ex, ey, ez, nx, ny, nz, refr, one))
        do_refract = solid & (sch < u_schl)
        rf_o = _refract(ex, ey, ez, nx, ny, nz, one, refr)
        rf_i = _refract(ex, ey, ez, nx, ny, nz, refr, one)
        rfx = torch.where(outside, rf_o[0], rf_i[0])
        rfy = torch.where(outside, rf_o[1], rf_i[1])
        rfz = torch.where(outside, rf_o[2], rf_i[2])
        solid_reflect = solid & ~do_refract
        diffuse = (~do_reflect) & (~thin) & (~solid)

        rand1 = 2.0 * math.pi * u1
        rand2s = torch.sqrt(u2)
        pick = torch.abs(nx) > 0.1
        axx = torch.where(pick, 0.0, one)
        axy = torch.where(pick, one, 0.0)
        ux, uy, uz = _normalize(axy * nz, -(axx * nz), axx * ny - axy * nx)
        vx2 = ny * uz - nz * uy
        vy2 = nz * ux - nx * uz
        vz2 = nx * uy - ny * ux
        cu = torch.cos(rand1) * rand2s
        cv = torch.sin(rand1) * rand2s
        cn = torch.sqrt(1.0 - u2)
        hx = ux * cu + vx2 * cv + nx * cn
        hy = uy * cu + vy2 * cv + ny * cn
        hz = uz * cu + vz2 * cv + nz * cn

        ddn = 2.0 * _dot(dx, dy, dz, nx, ny, nz)
        any_reflect = do_reflect | thin_reflect | solid_reflect

        def pick_dir(r, d, rf, h):
            return torch.where(any_reflect, r, torch.where(
                thin_pass, d, torch.where(do_refract, rf, h)))

        ndx = pick_dir(dx - nx * ddn, dx, rfx, hx)
        ndy = pick_dir(dy - ny * ddn, dy, rfy, hy)
        ndz = pick_dir(dz - nz * ddn, dz, rfz, hz)
        cos = torch.where(diffuse, _dot(hx, hy, hz, nx, ny, nz), 1.0)
        go_under = thin_pass | do_refract
        nox = torch.where(go_under, wx - nx * eps, wx + nx * eps)
        noy = torch.where(go_under, wy - ny * eps, wy + ny * eps)
        noz = torch.where(go_under, wz - nz * eps, wz + nz * eps)

        rec = alive & hit_ok
        if counts is not None:
            counts["hits"] = counts.get("hits", 0) + int(rec.sum())
        no_refr = rec & ~do_refract
        is_light = emi_r > 0.0
        srr = srr + torch.where(no_refr, mask_r * emi_r, 0.0)
        srg = srg + torch.where(no_refr, mask_g * emi_g, 0.0)
        srb = srb + torch.where(no_refr, mask_b * emi_b, 0.0)
        direct = no_refr & is_light & (n_hits == 0)
        srr = torch.where(direct, col_r, srr)
        srg = torch.where(direct, col_g, srg)
        srb = torch.where(direct, col_b, srb)
        upd = no_refr & ~is_light
        mask_r = torch.where(upd, mask_r * col_r * cos, mask_r)
        mask_g = torch.where(upd, mask_g * col_g * cos, mask_g)
        mask_b = torch.where(upd, mask_b * col_b * cos, mask_b)
        eff = eff + (rec & ~do_refract & ~any_reflect).to(torch.int32)
        n_hits = n_hits + rec.to(torch.int32)
        alive = (alive & hit_ok & ~(rec & is_light)
                 & (eff < render["max_effective_bounces"]))
        ox = torch.where(rec, nox, ox)
        oy = torch.where(rec, noy, oy)
        oz = torch.where(rec, noz, oz)
        dx = torch.where(rec, ndx, dx)
        dy = torch.where(rec, ndy, dy)
        dz = torch.where(rec, ndz, dz)
        inside = torch.where(rec & do_refract, outside, inside)
    return srr, srg, srb
