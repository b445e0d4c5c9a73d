"""Where K1's time goes: variants of csrc/fused_mlp.cu, each with one part of
the kernel taken out, timed at the exact eval path's shapes on one card.

    python -m nerf_siren_tpu_torch.k1_ablation

Each variant is the source with a text edit, compiled like the kernel
(`card_bench.build_variants`) and called through the same C interface. A
variant that drops work computes wrong numbers: only its time and its
`-Xptxas -v` spill bytes are read. The variants:
  as built           the kernel itself;
  no turns           the two consumer warpgroups' epilogues not taken in
                     alternation (each syncs only itself);
  no act epilogue    the epilogues that rewrite the activations skipped
                     (the hidden layers' in the sigma pass, every trunk
                     layer's in the full pass);
  no weight copy     the producer signals each stage without copying into it
                     (no L2 reads of the weights);
  no products        no wgmma issued (what the rest costs on its own);
  240 registers      setmaxnreg 240 for the consumers, 24 for the producer.
Prints one line per variant: sigma ms at 32768 rays x 64 points, full ms at
32768 x 192 points (one direction per ray), spill bytes of both
instantiations at the field's width (256), and the card's name and power
limit. Needs nvcc and a card.
"""
from __future__ import annotations

import ctypes
import re
import sys

import torch

from nerf_siren_tpu_torch.card_bench import build_variants, card, device_ms, edit, ptxas_props
from nerf_siren_tpu_torch.config import NeRFConfig
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import _build
from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm

SHAPES = {"sigma": (32768 * 64, 0), "full": (32768 * 192, 192)}   # points, samples per direction
REPS = 10


def variants(src: str) -> dict:
    """{label: source text}."""
    def regs(text, consumer, producer):
        text = edit(text, "reg_alloc<232>", f"reg_alloc<{consumer}>")
        return edit(text, "reg_dealloc<40>", f"reg_dealloc<{producer}>")

    no_turns = edit(src, "  if (wg == 1) sm90::named_bar_arrive(other_turn, 256);\n", "")
    no_turns = edit(no_turns, "      sm90::named_bar_sync(my_turn, 256);\n", "      wg_sync();\n")
    no_turns = edit(no_turns, "      sm90::named_bar_arrive(other_turn, 256);\n", "")
    no_turns = edit(no_turns, "  if (wg == 0) sm90::named_bar_sync(my_turn, 256);", "")
    act_epilogue = re.search(r"trunk_epilogue<true, false, W, BLOCK_BYTES>\([^;]*;", src).group(0)
    return {
        "as built": src,
        "no turns": no_turns,
        "no act epilogue": edit(src, act_epilogue, ";"),
        "no weight copy": edit(
            src, "      sm90::mbar_arrive_expect_tx(ring.full(), bytes);\n"
                 "      sm90::bulk_copy_g2s(ring.slot(), src, bytes, ring.full());",
            "      sm90::mbar_arrive(ring.full());"),
        "no products": edit(src, "sm90::wgmma_ss<N>(acc, da, db, j > 0 || kk > 0);",
                            "(void)da, (void)db;"),
        "240 registers": regs(src, 240, 24),
    }


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k1_ablation: needs a CUDA card")
    smi = card()
    dev = torch.device("cuda", 0)
    model = NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(0))
    packed = fm.pack_nerf_params(model, dev)
    weights, emb_mask, table = fm._kernel_args(packed, dev)
    width = packed["w_sigma"].shape[0]
    ptrs = (ctypes.c_void_p * len(table))(*table)
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = {}
    for key, (n, spd) in SHAPES.items():
        xyz = (torch.rand((n, 3), generator=gen, device=dev) - 0.5) * 8
        dirs = torch.nn.functional.normalize(torch.randn((n // 192, 3), generator=gen, device=dev),
                                             dim=-1)
        inputs[key] = (n, spd, xyz, dirs, torch.empty((n, 4 if spd else 1), device=dev))

    def launch(fn, key):
        n, spd, xyz, dirs, out = inputs[key]
        err = fn(weights.data_ptr(), weights.numel(), ptrs, fm._depth(packed), emb_mask,
                 width, xyz.data_ptr(), dirs.data_ptr() if spd else None, max(spd, 1),
                 out.data_ptr(), n, int(spd > 0), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"nerf_field_forward failed: cudaError {err}")

    src = (_build.CSRC_DIR / "fused_mlp.cu").read_text()
    for label, fn, log in build_variants(variants(src), "nerf_field_forward", fm.KERNEL_ARGTYPES):
        props = ptxas_props(log)
        spills = [next(v[1] for k, v in props.items()
                       if f"nerf_field_kernelILi{width}ELb{full}E" in k) for full in (0, 1)]
        times = {key: device_ms(lambda: launch(fn, key), REPS) for key in SHAPES}
        print(f"[k1_ablation] {label:18s} sigma {times['sigma']:.3f} ms, full "
              f"{times['full']:.3f} ms; spill bytes (sigma, full) {tuple(spills)}; {smi}",
              flush=True)


if __name__ == "__main__":
    main()
