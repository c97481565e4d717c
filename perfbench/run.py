"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic mix, limits and metrics are found by
name from ``BENCHMARK.json`` (see ``perfbench/README.md``). With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from two shorter profiled
passes (``harness/trace.py``: a timing pass that records the device's
activity alone, an attribution pass with host ops and spans), and the
``breakdown``. Exits non-zero, printing no
result, without enough CUDA cards or when a JAX module was loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import common  # noqa: E402


def main(argv=None) -> int:
    args = common.parse_args(argv)
    common.set_cache_dirs()
    ctx = common.cell(args.workload)
    import torch
    chips = int(ctx['work']['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'needs {chips} CUDA card(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    ctx.update(args=args, t0=T0)
    from harness.runner import execute
    common.report(execute(ctx, 'cuda'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
