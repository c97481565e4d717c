"""What every run shares: the arguments, the lookup of a cell's files by
name, the build caches inside the checkout, the result line and the
checks that no JAX module was loaded."""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import Dict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'boxinstseg_tpu')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Run one benchmark cell once.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    no library that the port uses may load JAX by itself."""
    cache = os.path.join(HERE, '_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache,
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def cell(name: str) -> Dict:
    """The workload entry of ``name``, its configuration file, its traffic
    mix and its limits (empty when the cell has none yet)."""
    bench = benchmark()
    work = next((w for w in bench['workloads'] if w['name'] == name), None)
    if work is None:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
    conf = next(c for c in bench['configs'] if c['name'] == work['config'])
    with open(os.path.join(ROOT, conf['file'])) as f:
        cfg = json.load(f)
    mix = load_json('traffic', f'{work["traffic"]}.json')
    path = os.path.join(HERE, 'limits', f'{name}.json')
    limits = {}
    if os.path.exists(path):
        with open(path) as f:
            limits = json.load(f)['limits']
    metrics = {'end_to_end': [], 'per_layer': []}
    for kind in metrics:
        for m in bench[kind]:
            if name in m.get('workloads', [name]):
                metrics[kind].append(m)
    return dict(work=work, cfg=cfg, mix=mix, limits=limits, bench=bench,
                metrics=metrics)


def load_reader(name: str):
    """``read(records)`` of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(HERE, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        'perfbench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN))


def check_no_jax() -> None:
    found = forbidden_modules()
    if found:
        print(f'forbidden modules loaded: {found}', file=sys.stderr)
        raise SystemExit(3)


def device_info(count: int) -> Dict:
    import torch
    return dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                count=count,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated()))


def report(result: Dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result line on standard output, the compared numbers last in it."""
    for k, v in result['checks'].items():
        print(f'check {k}: {v["value"]!r} limit {v["limit"]!r}',
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def checks_of(gaps: Dict[str, float], limits: Dict[str, float]) -> Dict:
    keys = list(limits) or [k for k in gaps if isinstance(gaps[k], float)]
    return {k: dict(value=gaps[k], limit=limits.get(k)) for k in keys}
