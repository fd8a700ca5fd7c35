"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference (shgbench/reference), each beside its limit.

Every number is a distance, so a check passes when the number is at most
its limit.  The limits of a cell sit in ``shgbench/limits/<cell>.json``;
only the numbers named there are checked, the others are printed.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict

import numpy as np


def read_png(path: str) -> np.ndarray:
    """A 16- or 8-bit grey-scale PNG as a uint16 or uint8 array (filter
    type 0, no interlace; any other filter type raises)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype != 0 or interlace != 0 or depth not in (8, 16):
        raise ValueError(f"{path}: colour type {ctype}, depth {depth}, "
                         f"interlace {interlace} not read")
    stride = w * (depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(
        h, stride + 1)
    if raw[:, 0].any():
        # the port's encoder writes filter type 0 only (io/png.py)
        raise ValueError(f"{path}: PNG filter types "
                         f"{sorted(set(raw[:, 0].tolist()))} not read")
    out = raw[:, 1:]
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w)
    return out.reshape(h, w)


def image_numbers(img: np.ndarray, ref: np.ndarray, prefix: str = "png"
                  ) -> Dict[str, float]:
    """Distances between a product image and the reference's: on the
    common top-left area, and the difference of their shapes."""
    h = min(img.shape[0], ref.shape[0])
    w = min(img.shape[1], ref.shape[1])
    d = np.abs(img[:h, :w].astype(np.int64) - ref[:h, :w].astype(np.int64))
    return {
        f"{prefix}_shape_px": float(max(abs(img.shape[0] - ref.shape[0]),
                                        abs(img.shape[1] - ref.shape[1]))),
        f"{prefix}_mean_lsb": float(d.mean()),
        f"{prefix}_p99_lsb": float(np.percentile(d, 99)),
        f"{prefix}_max_lsb": float(d.max()),
        f"{prefix}_off_pct": float(100.0 * np.count_nonzero(d > 655) / d.size),
    }


def scan_numbers(prog: Dict[str, object], ref: Dict[str, object]
                 ) -> Dict[str, float]:
    """Pass A's mean, the line fit, pass B's disks, the ellipse geometry,
    and each requested shift's circularised disk and transversalium row
    gain (``products``, by shift) of one scan against the reference's; the
    warp and gain numbers are the worst over the reference's shifts."""
    mean = np.asarray(prog["mean"]).astype(np.int64)
    d = np.abs(np.asarray(prog["disks"]).astype(np.int64)
               - ref["disks"].astype(np.int64))
    geo = ref["geometry"]
    out = {
        "passa_mean_lsb": float(np.abs(mean - ref["mean"].astype(np.int64)).max()),
        "linefit_px": float(np.abs(np.asarray(prog["curve"])
                                   - ref["fit"]["curve"]).max()),
        "disk_max_lsb": float(d.max()),
        "disk_off_pct": float(100.0 * np.count_nonzero(d) / d.size),
        "ratio_rel": float(abs(prog["ratio"] / geo["ratio"] - 1.0)),
        "tilt_deg": float(abs(prog["tilt_deg"] - np.degrees(geo["phi"]))),
    }
    rows = []
    for shift, r in ref["products"].items():
        p = prog["products"].get(shift, {})
        # a stage whose output the run did not capture reads as infinitely
        # far
        if "warped" in p:
            row = image_numbers(p["warped"], r["warped"], "warp")
        else:
            row = {"warp_off_pct": float("inf")}
        if "gain" in p:
            g, rg = np.asarray(p["gain"]), np.asarray(r["gain"])
            n = min(len(g), len(rg))       # rows of the common area
            row["gain_max"] = float(np.abs(g[:n] - rg[:n]).max())
        else:
            row["gain_max"] = float("inf")
        rows.append(row)
    out.update(worst(rows))
    return out


def product_numbers(images: Dict[int, np.ndarray], ref: Dict[str, object]
                    ) -> Dict[str, float]:
    """Each shift's product image (``images``, by shift) against the
    reference's of that shift, the worst over shifts under ``png_*``."""
    return worst(image_numbers(img, ref["products"][s]["clahe"], "png")
                 for s, img in images.items())


def reference_as_program(ref: Dict[str, object]) -> Dict[str, object]:
    """The reference's results in the program's place (the control)."""
    geo = ref["geometry"]
    return {"mean": ref["mean"], "curve": ref["fit"]["curve"],
            "disks": ref["disks"], "ratio": geo["ratio"],
            "tilt_deg": float(np.degrees(geo["phi"])),
            "products": ref["products"]}


def control_numbers(low: Dict[str, object], ref: Dict[str, object]
                    ) -> Dict[str, float]:
    """Every compared number of the control (``low``, the reference on cut
    samples) in the program's place, against the reference."""
    nums = scan_numbers(reference_as_program(low), ref)
    nums.update(product_numbers(
        {s: p["clahe"] for s, p in low["products"].items()}, ref))
    return nums


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Dict[str, float]]:
    """{name: {value, limit}} of the limited numbers, in the limits' order;
    a number that is missing reads as infinite."""
    return {k: {"value": numbers.get(k, float("inf")), "limit": v}
            for k, v in limits.items()}


def passed(chk: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in chk.values())


def worst(rows) -> Dict[str, float]:
    """Element-wise maximum of several dicts of numbers."""
    out: Dict[str, float] = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, float("-inf")), v)
    return out
