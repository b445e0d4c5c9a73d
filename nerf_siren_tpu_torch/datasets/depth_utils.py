"""PFM depth-map read/write (reference: datasets/depth_utils.py).

PFM: ASCII header ('Pf' grayscale / 'PF' color), "<w> <h>", scale line whose
sign encodes endianness, then raw float32 rows bottom-to-top.
"""
from __future__ import annotations

import numpy as np


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("image must be HxW, HxWx1 or HxWx3")

    endian = image.dtype.byteorder
    if endian == "<" or (endian == "=" and np.little_endian):
        scale = -scale

    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


def load_pfm(path: str):
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().rstrip())
        big_endian = scale > 0
        data = np.fromfile(f, ">f" if big_endian else "<f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)
