"""NumPy reference implementation of the reference's hand-made KLT
(src/algorithm.cpp:37-206), used only to validate the batched device kernels.
Implements the same semantics: clamped bilinear lookup, 7x7 patch, central
differences, 10 GN iterations, divergence/convergence breaks, 4-level
pyramid with 0.5 scaling and failed-lane reset."""

import numpy as np


def get_pixel_value(img, x, y):
    H, W = img.shape
    x = min(max(x, 0.0), W - 1.0)
    y = min(max(y, 0.0), H - 1.0)
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    x1, y1 = min(x0 + 1, W - 1), min(y0 + 1, H - 1)
    xx, yy = x - x0, y - y0
    return (
        (1 - xx) * (1 - yy) * img[y0, x0]
        + xx * (1 - yy) * img[y0, x1]
        + (1 - xx) * yy * img[y1, x0]
        + xx * yy * img[y1, x1]
    )


def klt_1layer(img1, img2, kp1, kp2, inverse=False, has_initial=True,
               half_patch=3, iterations=10, eps=1e-2):
    n = len(kp1)
    out = np.array(kp2 if has_initial else kp1, dtype=np.float64).copy()
    success = np.zeros(n, bool)
    H, W = img2.shape
    for i in range(n):
        x0, y0 = kp1[i]
        dx, dy = (out[i][0] - x0, out[i][1] - y0) if has_initial else (0.0, 0.0)
        last_cost = 0.0
        succ = True
        Hm = np.zeros((2, 2))
        J = np.zeros(2)
        for it in range(iterations):
            if not inverse:
                Hm = np.zeros((2, 2))
            b = np.zeros(2)
            cost = 0.0
            for ox in range(-half_patch, half_patch + 1):
                for oy in range(-half_patch, half_patch + 1):
                    err = get_pixel_value(img1, x0 + ox, y0 + oy) - get_pixel_value(
                        img2, x0 + ox + dx, y0 + oy + dy
                    )
                    if not inverse:
                        J = -1.0 * np.array([
                            0.5 * (get_pixel_value(img2, x0 + ox + dx + 1, y0 + oy + dy)
                                   - get_pixel_value(img2, x0 + ox + dx - 1, y0 + oy + dy)),
                            0.5 * (get_pixel_value(img2, x0 + ox + dx, y0 + oy + dy + 1)
                                   - get_pixel_value(img2, x0 + ox + dx, y0 + oy + dy - 1)),
                        ])
                    elif it == 0:
                        J = -1.0 * np.array([
                            0.5 * (get_pixel_value(img1, x0 + ox + 1, y0 + oy)
                                   - get_pixel_value(img1, x0 + ox - 1, y0 + oy)),
                            0.5 * (get_pixel_value(img1, x0 + ox, y0 + oy + 1)
                                   - get_pixel_value(img1, x0 + ox, y0 + oy - 1)),
                        ])
                    b += -err * J
                    cost += err * err
                    if not inverse or it == 0:
                        Hm += np.outer(J, J)
            try:
                upd = np.linalg.solve(Hm, b)
            except np.linalg.LinAlgError:
                succ = False
                break
            if not np.all(np.isfinite(upd)):
                succ = False
                break
            if it > 0 and cost > last_cost:
                break
            dx += upd[0]
            dy += upd[1]
            last_cost = cost
            succ = True
            if np.linalg.norm(upd) < eps:
                break
        success[i] = succ
        out[i] = [x0 + dx, y0 + dy]
        if not (0 <= out[i][0] < W and 0 <= out[i][1] < H):
            success[i] = False
    return out, success


def down2(img):
    H, W = img.shape
    h, w = H // 2, W // 2
    return img[: 2 * h, : 2 * w].reshape(h, 2, w, 2).mean(axis=(1, 3))


def klt_4layer(img1, img2, kp1, kp2_init, inverse=False, levels=4, scale=0.5):
    pyr1, pyr2 = [img1], [img2]
    for _ in range(levels - 1):
        pyr1.append(down2(pyr1[-1]))
        pyr2.append(down2(pyr2[-1]))
    s_top = scale ** (levels - 1)
    k1 = np.asarray(kp1, np.float64) * s_top
    k2 = np.asarray(kp2_init, np.float64) * s_top
    success = None
    for level in range(levels - 1, -1, -1):
        k2, success = klt_1layer(pyr1[level], pyr2[level], k1, k2, inverse=inverse)
        if level > 0:
            k1 = k1 / scale
            k2 = np.where(success[:, None], k2 / scale, k1)
    return k2, success
