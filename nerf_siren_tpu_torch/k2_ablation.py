"""Where the time of K2 goes: variants of csrc/fused_mlp_train.cu, each with
one part of the tile kernel taken out (or the forward's ring one stage
shorter), timed at the training step's shapes on one card. The forward is
the tile kernel in its forward mode, so an edit of the code the two modes
share (the weight ring, the products) reaches both.

    python -m nerf_siren_tpu_torch.k2_ablation

Each variant is the source with a text edit, compiled like the kernel
(`card_bench.build_variant_libs`) and called through the same C interface. A
variant that drops work computes wrong numbers: only its times and its
`-Xptxas -v` spill bytes are read. The variants:
  as built           the kernels themselves;
  no stash stores    the backward's tile kernel writes nothing to the stash
                     (the weight gradients then read stale bytes: their
                     time stands, their values do not); the forward has
                     none to drop;
  no weight copy     the producer signals each stage without copying into
                     it (no L2 reads of the weight stream), both modes;
  no products        the tile kernel issues no wgmma, both modes;
  no L2 policies     the weight stream's copies without evict_last (both
                     modes) and the stash's stores without evict_first;
  no bias sums       the dgrad epilogues skip the bias gradients'
                     column sums (the reduce-scatter and its stores); the
                     forward has none;
  forward 3 stages   the forward's ring with the backward's 3 stages in
                     place of 4 (the backward unchanged).
Prints one line per variant: the forward's and the backward's device ms
per step (coarse 1024 x 64 + fine 1024 x 192 points), each of the
backward's three kernels' device ms (`torch.profiler`), both tile
kernels' spill bytes, and the card's name and power limit. Needs nvcc and
a card.
"""
from __future__ import annotations

import re
import sys

import torch

from nerf_siren_tpu_torch.card_bench import build_variant_libs, card, device_ms, edit, kernel_ms
from nerf_siren_tpu_torch.config import NeRFConfig
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import _build
from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

RAYS, SAMPLES = 1024, (64, 192)   # the training step's two launches
REPS = 5
KERNELS = {"tile": "nerf_train_bwd_tile_kernel", "wgrad": "nerf_train_wgrad_kernel",
           "reduce": "nerf_train_reduce_kernel"}
FWD_KERNEL = "nerf_train_fwd_tile_kernel"


def variants(src: str) -> dict:
    """{label: source text}."""
    no_sums = edit(src, "  colsum_out(cs, brow, at, lane);\n}", "  (void)cs;\n}")
    no_sums = edit(no_sums, "      colsum_out(cs, brow, B_DIR, lane);\n", "")
    return {
        "as built": src,
        "no stash stores": edit(src, "    sm90::bulk_copy_s2g(dst, src, bytes, stream_out);\n",
                                "    (void)dst, (void)src, (void)bytes;\n"),
        "no weight copy": edit(
            src, "      sm90::mbar_arrive_expect_tx(ring.full(), bytes);\n"
                 "      sm90::bulk_copy_g2s_hint(ring.slot(), src, bytes, ring.full(), keep);",
            "      sm90::mbar_arrive(ring.full());"),
        "no L2 policies": edit(edit(
            src, "bulk_copy_s2g(dst, src, bytes, stream_out);", "bulk_copy_s2g(dst, src, bytes);"),
            "bulk_copy_g2s_hint(ring.slot(), src, bytes, ring.full(), keep);",
            "bulk_copy_g2s(ring.slot(), src, bytes, ring.full());"),
        "no products": edit(edit(
            src, "sm90::wgmma_m64n256k16<1>(acc, da, db, j > 0 || kk > 0);", "(void)da;"),
            "sm90::wgmma_m64n128k16<1>(acc, da, db, j > 0 || kk > 0);", "(void)db;"),
        "no bias sums": no_sums,
        "forward 3 stages": edit(src, "static constexpr int STAGES = FWD ? 4 : 3;",
                                 "static constexpr int STAGES = 3;"),
    }


def tile_spills(log: str, symbol: str = KERNELS["tile"]) -> int:
    """Spill bytes (stores + loads) of a tile kernel in an -Xptxas -v log."""
    kernel = ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and symbol in kernel:
            return int(m.group(1)) + int(m.group(2))
    raise RuntimeError(f"no spill report of {symbol} in the build log")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k2_ablation: needs a CUDA card")
    smi = card()
    dev = torch.device("cuda", 0)
    model = NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(0)).to(dev)
    packed = k2.pack_train_params(model.state_dict())
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = []
    for s in SAMPLES:
        n = RAYS * s
        xyz = (torch.rand((n, 3), generator=gen, device=dev) - 0.5) * 8
        dirs = torch.nn.functional.normalize(torch.randn((RAYS, 3), generator=gen, device=dev),
                                             dim=-1)
        dy = torch.rand((n, 4), generator=gen, device=dev) * 2 - 0.5
        inputs.append((s, xyz, dirs, dy))
    lib = k2._lib()
    entries = ("nerf_train_forward", "nerf_train_backward")

    src = (_build.CSRC_DIR / "fused_mlp_train.cu").read_text()
    for label, built, log in build_variant_libs(variants(src)):
        fwd, bwd = (getattr(built, e) for e in entries)
        for fn, e in zip((fwd, bwd), entries):
            fn.argtypes, fn.restype = getattr(lib, e).argtypes, getattr(lib, e).restype

        def forward():
            for s, xyz, dirs, _ in inputs:
                k2._launch_fwd(packed, xyz, dirs, s, entry=fwd)

        def step():
            for s, xyz, dirs, dy in inputs:
                k2._launch_bwd(packed, xyz, dirs, dy, s, entry=bwd)

        fwd_ms = sum(v for name, v in kernel_ms(forward, REPS).items() if FWD_KERNEL in name)
        total = device_ms(step, REPS)
        per = kernel_ms(step, REPS)
        own = {k: sum(v for name, v in per.items() if sym in name) for k, sym in KERNELS.items()}
        print(f"[k2_ablation] {label:16s} forward {fwd_ms:.3f} ms per step (spill bytes "
              f"{tile_spills(log, FWD_KERNEL)}); backward {total:.3f} ms per step; tile "
              f"{own['tile']:.3f}, wgrad {own['wgrad']:.3f}, reduce {own['reduce']:.3f} ms; "
              f"tile kernel spill bytes {tile_spills(log)}; {smi}", flush=True)


if __name__ == "__main__":
    main()
