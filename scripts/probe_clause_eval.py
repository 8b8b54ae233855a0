#!/usr/bin/env python3
"""Where the time of ``src/repro_torch/csrc/clause_eval.cu`` goes, phase by
phase, on one NVIDIA GPU.

    python3 scripts/probe_clause_eval.py

Builds variants of the kernel source with one phase switched off each (a
``PROBE_MODE`` macro patched into a copy of the text, under
``build/probe/``) and times ``clause_outputs_packed`` at (B, m, n, W) =
(32, 10, 2000, 49), the tiled route's shape on the main path, with the
default launch plan and chip_smoke.py's served state, by CUDA-graph replay.
The variants compute wrong outputs (only "as is" is checked against the
plain version); their times bound what each phase costs:

  as is                      the kernel
  no compute loop            staging and epilogue, no LOP3s
  no include staging         compute on stale shared memory
  neither                    literal staging and epilogue only
  no output stores           everything but the epilogue's stores
  literal staging only       the literal copy, its wait and the barriers
  literal staging, replicas  the same, each block reading one of 64 copies
                             of the literal words (tests L2 contention)
  empty kernel               returns at once: the launch floor
  include staging only       the include rows' copy, its wait, the barriers
  literal staging only, plain loads
                             the literal copy as plain loads, all of a
                             lane's issued before its shared stores (W <= 64)

Imports no JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402

REPS = 100
REPLICAS = 64
MODES = {0: "as is", 1: "no compute loop", 2: "no include staging",
         3: "neither", 4: "no output stores", 5: "literal staging only",
         6: "literal staging, replicas", 7: "empty kernel",
         8: "include staging only", 9: "literal staging only, plain loads"}
NO_COMPUTE = (1, 3, 5, 6, 8, 9)
NO_INCLUDE = (2, 3, 5, 6, 9)
NO_STORES = (4, 5, 6, 8, 9)


def _any(modes) -> str:
    return "(" + " || ".join(f"PROBE_MODE == {m}" for m in modes) + ")"


def probe_source() -> str:
    """The kernel source with the PROBE_MODE switches patched in."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "clause_eval.cu").read_text()
    patches = [
        ("for (int w = 0; w < s.wn; ++w) {",
         f"for (int w = 0; w < ({_any(NO_COMPUTE)} ? 0 : s.wn); ++w) {{"),
        ("  auto stage_inc = [&](uint32_t* buf, const Stage& s) {\n",
         "  auto stage_inc = [&](uint32_t* buf, const Stage& s) {\n"
         f"    if {_any(NO_INCLUDE)} return;\n"),
        ("if (b < g.B) o[",
         f"if ({_any(NO_STORES)} ? b < g.B - 100000 * g.n_chunks : b < g.B) o["),
        ("      const uint32_t* src = lit + static_cast<size_t>(b0 + b) * g.W + w0;\n",
         "      const uint32_t* src = lit + static_cast<size_t>(b0 + b) * g.W + w0"
         " + (PROBE_MODE == 6 ? static_cast<size_t>(blockIdx.x % "
         f"{REPLICAS}) * g.B * g.W : 0);\n"),
        ("  auto stage_lit = [&](uint32_t* dst, int w0, int wn) {\n",
         "  auto stage_lit = [&](uint32_t* dst, int w0, int wn) {\n"
         "    if (PROBE_MODE == 8) return;\n"
         "    if (PROBE_MODE == 9) {  // all of a lane's loads, then its stores\n"
         "      for (int b = warp; b < bt; b += 4 * n_warps) {\n"
         "        uint32_t r[4][2];\n"
         "#pragma unroll\n"
         "        for (int u = 0; u < 4; ++u)\n"
         "#pragma unroll\n"
         "          for (int t = 0; t < 2; ++t) {\n"
         "            const int bb = b + u * n_warps, w = lane + 32 * t;\n"
         "            r[u][t] = bb < bt && b0 + bb < g.B && w < wn ? __ldg(lit + "
         "static_cast<size_t>(b0 + bb) * g.W + w0 + w) : 0u;\n"
         "          }\n"
         "#pragma unroll\n"
         "        for (int u = 0; u < 4; ++u)\n"
         "#pragma unroll\n"
         "          for (int t = 0; t < 2; ++t) {\n"
         "            const int bb = b + u * n_warps, w = lane + 32 * t;\n"
         "            if (bb < bt && w < wn) dst[w * ls + bb] = r[u][t];\n"
         "          }\n"
         "      }\n"
         "      return;\n"
         "    }\n"),
        ("  extern __shared__ __align__(16) uint32_t smem[];\n",
         "  extern __shared__ __align__(16) uint32_t smem[];\n"
         "  if (PROBE_MODE == 7) return;\n"),
    ]
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"probe: the kernel source changed near {old!r}")
        src = src.replace(old, new)
    return src


def build(out: Path) -> dict[int, ctypes.CDLL]:
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    (out / "clause_eval_probe.cu").write_text(probe_source())
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {k: subprocess.Popen(
        [_build.nvcc_path(), *flags, f"-DPROBE_MODE={k}", "-o",
         str(out / f"probe{k}.so"), str(out / "clause_eval_probe.cu")],
        stderr=subprocess.PIPE, text=True) for k in MODES}
    libs = {}
    for k, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for probe mode {k}:\n{err}")
        lib = ctypes.CDLL(str(out / f"probe{k}.so"))
        p = ctypes.c_void_p
        lib.clause_outputs_launch.argtypes = [p, p, p, *[ctypes.c_int] * 14, p]
        libs[k] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_clause_eval: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.tm import PAPER_TM_CONFIGS
    from repro_torch.core.bitpack import packed_literals
    from repro_torch.core.session import TMSession
    from repro_torch.core.types import TMState
    from repro_torch.kernels import clause_eval as ce

    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    libs = build(ROOT / "build" / "probe")
    exp = PAPER_TM_CONFIGS["tm_mnist"]
    cfg = exp.tm
    gen = torch.Generator(device=dev).manual_seed(0)
    ta, inc = chip_smoke.served_state(cfg, int(exp.avg_clause_len), gen, dev)
    words = TMSession(cfg, engines=("bitpack",), device=dev).prepare(
        TMState(ta_state=ta)).caches["bitpack"]
    b, (m, n, w) = 32, words.shape
    lw = packed_literals(chip_smoke.requests(inc, b, gen, dev))
    replicas = lw.repeat(REPLICAS, 1).contiguous()
    plan = ce.launch_plan(b, m, n, w)
    want = ce.clause_outputs_ref(words, lw)
    print(f"clause_outputs_packed (B, m, n, W)=({b}, {m}, {n}, {w}), "
          + chip_smoke.plan_line(plan, torch.cuda.get_device_properties(0)
                                 .multi_processor_count))
    for k, lib in libs.items():
        out = torch.empty((b, m, n), dtype=torch.int8, device=dev)
        lit = replicas if k == 6 else lw

        def run():
            code = lib.clause_outputs_launch(
                words.data_ptr(), lit.data_ptr(), out.data_ptr(),
                *ce._plan_args(plan, m, n, w, b),
                torch.cuda.current_stream().cuda_stream)
            assert code == 0, code

        run()
        torch.cuda.synchronize()
        if k == 0 and not torch.equal(out, want):
            raise RuntimeError("probe: the unpatched kernel != plain")
        print(f"probe [{MODES[k]}]: device ms {chip_smoke.device_ms(run, REPS):.5f} "
              f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
