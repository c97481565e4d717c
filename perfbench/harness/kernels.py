"""The rooflines of the registered ops: each op's operations and bytes
come from ``perfbench/kernels/<namespace>.<op>.py`` (``cost(shapes,
dtypes) -> (operations, bytes)``, from the shapes and types of the op's
inputs as the profiler recorded them), found by the op's name, never from
the program's own flop formulas.

A kernel whose work depends on its inputs' values, not only on their
shapes (one that skips what carries no weight), names in ``RECORD`` a
function of the frozen reference, (module, name), that receives the same
inputs, and gives ``inputs(*args, **kwargs)``, which reduces one call's
arguments to the counts that its ``cost(shapes, dtypes, live)`` takes.
The harness runs the reference over the traced window's batches with
that function watched (``recorded_inputs``), and the i-th watched call
goes with the op's i-th call in the window.

The bound of a call is the larger of operations / peak FLOP/s and bytes
(each input read once, each output written once) / peak bytes/s, with
NVIDIA's published H100 SXM figures (67 TFLOP/s fp32 outside the tensor
cores, 3.35 TB/s HBM3)."""
from __future__ import annotations

import importlib.util
import os
from collections import defaultdict
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

DTYPE_BYTES = {'float': 4, 'c10::BFloat16': 2, 'c10::Half': 2,
               'double': 8, 'bool': 1, 'unsigned char': 1,
               'signed char': 1, 'long int': 8, 'int': 4, 'short int': 2}


def numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def tensor_bytes(shape, dtype: str) -> int:
    return numel(shape) * DTYPE_BYTES.get(dtype, 4) if shape else 0


def load_file(name: str):
    """The module ``perfbench/kernels/<name>.py``, or None."""
    path = os.path.join(HERE, 'kernels', name + '.py')
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(
        'perfbench_kernel_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_module(op: str):
    """The kernel file of ``op`` ('ns::name'), or None."""
    return load_file(op.replace('::', '.'))


def load_cost(op: str):
    """The ``cost`` function of ``op`` ('ns::name'), or None."""
    mod = load_module(op)
    return None if mod is None else mod.cost


def recorded_inputs(ops, run_reference) -> Dict[str, list]:
    """For each of ``ops`` whose kernel file has a ``RECORD``, the
    ``inputs`` of every call of the recorded reference function, in order,
    while ``run_reference()`` runs; nothing is run when none has one."""
    watch = defaultdict(list)
    for op in ops:
        mod = load_module(op)
        if mod is not None and hasattr(mod, 'RECORD'):
            watch[tuple(mod.RECORD)].append((op, mod.inputs))
    out = {op: [] for users in watch.values() for op, _ in users}
    if not watch:
        return out
    restore = []
    for (module, name), users in watch.items():
        target = importlib.import_module(module)
        inner = getattr(target, name)

        def watched(*args, _inner=inner, _users=users, **kwargs):
            for op, summarise in _users:
                out[op].append(summarise(*args, **kwargs))
            return _inner(*args, **kwargs)

        setattr(target, name, watched)
        restore.append((target, name, inner))
    try:
        run_reference()
    finally:
        for target, name, inner in restore:
            setattr(target, name, inner)
    return out


def bound_seconds(ops: float, nbytes: float,
                  peak_flops: float = PEAK_FP32_FLOPS) -> float:
    return max(ops / peak_flops, nbytes / PEAK_BYTES_PER_S)


def roofline_percent(rec: Dict, ops: List[str]) -> Optional[float]:
    """100 x the summed bound time of every call of ``ops`` in the traced
    window over their summed device time; None when none ran, or when a
    kernel that needs its inputs' counts lacks them for a call."""
    device = sum(rec['op_device_s'].get(op, 0.0) for op in ops)
    if device <= 0:
        return None
    bound = 0.0
    for op in ops:
        mod = load_module(op)
        calls = rec['op_calls'].get(op, [])
        if hasattr(mod, 'RECORD'):
            live = (rec.get('op_inputs') or {}).get(op)
            if live is None or len(live) != len(calls):
                return None
            costs = [mod.cost(s, d, c) for (s, d), c in zip(calls, live)]
        else:
            costs = [mod.cost(s, d) for s, d in calls]
        if any(c is None for c in costs):
            return None
        bound += sum(bound_seconds(n_ops, nbytes) for n_ops, nbytes in costs)
    return 100.0 * bound / device
