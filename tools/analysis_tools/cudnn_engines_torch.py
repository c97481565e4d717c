#!/usr/bin/env python
"""The cuDNN engine each process ran for each convolution, from cuDNN's
API logs (level 3), and where two processes ran different ones.

    python tools/analysis_tools/cudnn_engines_torch.py ONE.log.gz OTHER.log.gz ...

Reads each log (as ``chip_smoke.py --cudnn-log DIR`` leaves them, gzipped
or not), takes every ``cudnnBackendExecute`` call of an execution plan, and
keys it by the operation, its tensors' dimensions (input, filter, output)
and its strides, padding and dilation. Prints, for the first log
against each other one, the keys that both ran with different (engine id,
knobs), with how many calls ran each; and the keys one log has and the
other has not.
"""
import argparse
import collections
import gzip
import re

DIMS = re.compile(r'dimA: type=int; val=\[([\d,]*)\]')
CONV = re.compile(r'(?:upperPadA|lowerPadA|strideA|dilationA): '
                  r'type=int; val=\[([\d,]*)\]')
OPERATION = re.compile(r'operation: type=CUDNN_BACKEND_OPERATION_(\w+)')
ENGINE = re.compile(r'engine_id: type=int; val=(\d+)')
KNOB = re.compile(r'CUDNN_KNOB_TYPE_(\w+): type=int; val=(-?\d+)')


def engines(path):
    """{(operation, dims, strides and pads): Counter({(engine id, knobs):
    calls})}."""
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
        text = f.read()
    out = collections.OrderedDict()
    for block in text.split('\n\n\n'):
        if 'function cudnnBackendExecute() called' not in block:
            continue
        op, engine = OPERATION.search(block), ENGINE.search(block)
        if op is None or engine is None:
            continue
        key = (op.group(1), tuple(DIMS.findall(block)),
               tuple(CONV.findall(block)))
        value = (int(engine.group(1)), tuple(KNOB.findall(block)))
        out.setdefault(key, collections.Counter())[value] += 1
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('logs', nargs='+')
    args = p.parse_args()
    first = engines(args.logs[0])
    print(f'{args.logs[0]}: {len(first)} operation keys')
    for path in args.logs[1:]:
        other = engines(path)
        apart = [k for k in other if k in first and
                 set(first[k]) != set(other[k])]
        print(f'{path}: {len(other)} keys, {len(apart)} run with other '
              f'engines, {len([k for k in other if k not in first])} keys '
              f'not in the first log, '
              f'{len([k for k in first if k not in other])} keys of the '
              f'first log not here')
        for k in apart:
            op, dims, _ = k
            print(f'  {op} {" -> ".join(dims)}: first '
                  f'{dict(first[k])}; this {dict(other[k])}')


if __name__ == '__main__':
    main()
