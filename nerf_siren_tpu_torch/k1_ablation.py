"""Where K1's time goes: variants of csrc/fused_mlp.cu, each with one part of
the kernel taken out, timed at the exact eval path's shapes on one card.

    python -m nerf_siren_tpu_torch.k1_ablation

Each variant is the source with a text edit, compiled like the kernel
(`ops/kernels/_build.py`'s flags) into a temporary directory and called
through the same C interface. A variant that drops work computes wrong
numbers: only its time and its `-Xptxas -v` spill bytes are read. The
variants:
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
instantiations, and the card's name and power limit. Needs nvcc and a card.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from nerf_siren_tpu_torch.config import NeRFConfig
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import _build
from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm

SHAPES = {"sigma": (32768 * 64, 0), "full": (32768 * 192, 192)}   # points, samples per direction
REPS = 10


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"csrc/fused_mlp.cu no longer holds {old[:60]!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """{label: source text}."""
    def regs(text, consumer, producer):
        text = _edit(text, "reg_alloc<232>", f"reg_alloc<{consumer}>")
        return _edit(text, "reg_dealloc<40>", f"reg_dealloc<{producer}>")

    no_turns = _edit(src, "  if (wg == 1) sm90::named_bar_arrive(other_turn, 256);\n", "")
    no_turns = _edit(no_turns, "      sm90::named_bar_sync(my_turn, 256);\n", "      wg_sync();\n")
    no_turns = _edit(no_turns, "      sm90::named_bar_arrive(other_turn, 256);\n", "")
    no_turns = _edit(no_turns, "  if (wg == 0) sm90::named_bar_sync(my_turn, 256);", "")
    act_epilogue = re.search(r"trunk_epilogue<true, false>\([^;]*;", src).group(0)
    return {
        "as built": src,
        "no turns": no_turns,
        "no act epilogue": _edit(src, act_epilogue, ";"),
        "no weight copy": _edit(
            src, "      sm90::mbar_arrive_expect_tx(ring.full(), bytes);\n"
                 "      sm90::bulk_copy_g2s(ring.slot(), src, bytes, ring.full());",
            "      sm90::mbar_arrive(ring.full());"),
        "no products": _edit(_edit(src, "sm90::wgmma_m64n256k16(acc, da, db, j > 0 || kk > 0);",
                                   "(void)da;"),
                             "sm90::wgmma_m64n128k16(acc, da, db, j > 0 || kk > 0);", "(void)db;"),
        "240 registers": regs(src, 240, 24),
    }


def build(label: str, text: str, tmp: Path):
    """(label, loaded nerf_field_forward, spill bytes per instantiation)."""
    name = re.sub(r"\W", "_", label)
    src = _build.CSRC_DIR / f"_ablation_{name}.cu"       # beside the headers it includes
    lib = tmp / f"lib{name}.so"
    src.write_text(text)
    try:
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                              capture_output=True, text=True)
    finally:
        src.unlink()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the {label!r} variant:\n{proc.stderr}")
    spills = [int(a) + int(b) for a, b in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                                                     r"loads", proc.stdout + proc.stderr)]
    fn = ctypes.CDLL(str(lib)).nerf_field_forward
    fn.argtypes = fm.KERNEL_ARGTYPES
    fn.restype = ctypes.c_int
    return label, fn, spills


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k1_ablation: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    model = NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(0))
    packed = fm.pack_nerf_params(model, dev)
    weights, emb_mask, table = fm._kernel_args(packed, dev)
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
                 fm.KERNEL_WIDTH, xyz.data_ptr(), dirs.data_ptr() if spd else None, max(spd, 1),
                 out.data_ptr(), n, int(spd > 0), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"nerf_field_forward failed: cudaError {err}")

    def ms(fn, key):
        launch(fn, key)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            launch(fn, key)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    with tempfile.TemporaryDirectory() as tmp:
        src = (_build.CSRC_DIR / "fused_mlp.cu").read_text()
        with concurrent.futures.ThreadPoolExecutor() as pool:
            built = list(pool.map(lambda kv: build(*kv, Path(tmp)), variants(src).items()))
        for label, fn, spills in built:
            times = {key: ms(fn, key) for key in SHAPES}
            print(f"[k1_ablation] {label:18s} sigma {times['sigma']:.3f} ms, full "
                  f"{times['full']:.3f} ms; spill bytes (sigma, full) {tuple(spills)}; {card}",
                  flush=True)


if __name__ == "__main__":
    main()
