"""Inputs of the row trim (ops/tiles._row_trim_counts), shared by the CPU
test that holds the plain version to the JAX package's and the card test
that holds kernel I to the plain version. numpy only: the card machine has
no JAX.

`table` draws gaussians as the depth-sorted binning sees them: an (N, 10)
float32 table [x, y, ca, cb, cc, op, 0, 0, 0, 0] (the trim reads the conic
and the centre as strided views of it) and (N, 4) int32 tile boxes
[x0, x1, y0, y1). Random ellipses, a few pixels to a few hundred across,
centred in and around the image, with boxes from their extent; then,
cycling over the rows, the edge rows the trim must get right: empty and
inverted boxes, a box over every tile row (h = max_h) and past the grid
(h > max_h), boxes on the last tile row, opacities at and below 1/255
(q <= 0), NaN and infinite conics and centres, and conics whose
determinant overflows."""
import numpy as np

EDGE_KINDS = 16


def table(rng, n: int, width: int, height: int, tile: int = 16):
    ntx, nty = -(-width // tile), -(-height // tile)
    x = rng.uniform(-0.2 * width, 1.2 * width, n)
    y = rng.uniform(-0.2 * height, 1.2 * height, n)
    s1 = np.exp(rng.uniform(np.log(0.3), np.log(120.0), n))
    s2 = s1 * rng.uniform(0.05, 1.0, n)
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cxx = c * c * s1 ** 2 + s * s * s2 ** 2
    cyy = s * s * s1 ** 2 + c * c * s2 ** 2
    cxy = c * s * (s1 ** 2 - s2 ** 2)
    det = cxx * cyy - cxy * cxy
    op = rng.uniform(0.0, 1.0, n)
    tab = np.zeros((n, 10), np.float32)
    tab[:, 0], tab[:, 1] = x, y
    tab[:, 2], tab[:, 3], tab[:, 4] = cyy / det, -cxy / det, cxx / det
    tab[:, 5] = op
    r = np.ceil(3.0 * s1)
    box = np.stack([np.floor((x - r) / tile), np.floor((x + r) / tile) + 1,
                    np.floor((y - r) / tile), np.floor((y + r) / tile) + 1],
                   axis=1)
    box[:, :2] = np.clip(box[:, :2], 0, ntx)
    box[:, 2:] = np.clip(box[:, 2:], 0, nty)
    box = box.astype(np.int32)
    # Edge rows: every EDGE_KINDS-th row from offset k takes kind k, so
    # small n still meets the first kinds and large n meets them all.
    kind = np.arange(n) % (3 * EDGE_KINDS)
    big = np.array([width / 2, height / 2, 2e-5, 0.0, 2e-5], np.float32)

    def rows(k):
        return kind == k

    box[rows(0), 3] = box[rows(0), 2]                       # h = 0
    box[rows(1), 2:] = box[rows(1), 3:1:-1]                 # h < 0
    tab[rows(2), 0:5] = big                                 # h = max_h
    box[rows(2)] = (0, ntx, 0, nty)
    box[rows(3)] = (0, ntx, -3, nty + 5)                    # h > max_h
    tab[rows(3), 0:5] = big
    box[rows(4), 2:] = (nty - 1, nty)                       # last row
    tab[rows(4), 1] = height - rng.uniform(0, tile, rows(4).sum())
    tab[rows(5), 5] = 1.0 / 255.0                           # q = 0
    tab[rows(6), 5] = rng.uniform(0.0, 1.0 / 255.0, rows(6).sum())
    tab[rows(7), 2] = np.nan                                # NaN conic
    tab[rows(8), 3] = np.nan
    tab[rows(9), 0] = np.nan                                # NaN centre
    tab[rows(10), 1] = np.nan
    tab[rows(11), 2] = np.inf                               # inf conic
    tab[rows(12), 3] = -np.inf
    tab[rows(13), 0] = np.inf                               # inf centre
    tab[rows(14), 1] = -np.inf
    tab[rows(15), 2:5] = (1e30, 0.0, 1e30)                  # det overflows
    box[rows(15), 0:2] = (0, ntx)
    return tab, box
