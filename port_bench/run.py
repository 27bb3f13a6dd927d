"""The benchmark of the PyTorch/CUDA port, one cell once in this process.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

run from the root of a checkout. It sets the cell up (the kernel library
from its cache inside the checkout, the scene, the renderer and its
first frames, the warm-up), measures for ``--seconds``, checks what the
window produced against the plain reference, and prints one JSON object
as the last line of its output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics with ``--trace 0``, the per-layer
ones with ``--trace 1``), ``device`` and, traced, ``breakdown``; the
numbers the check compared, each beside its limit, come last in it
(``check``) and as the last lines of standard error. Without the CUDA
cards the cell asks for it exits with code 2 and prints no result, as it
does when JAX or the JAX package is loaded once the window has closed.
``--device cpu`` rehearses a cell on the CPU at its configuration's
rehearsal size; such a line says ``"rehearsal": true`` and measures
nothing of the card.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "port_bench" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="rehearse on the CPU at the rehearsal size")
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))
    from port_bench.harness import card, runner

    try:
        result = runner.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), T0, device_name=args.device)
    except card.NoCard as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    loaded = card.forbidden_modules()
    if loaded:
        print("port_bench: the run loaded JAX or the JAX package: "
              + ", ".join(loaded), file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
