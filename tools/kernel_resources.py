#!/usr/bin/env python3
"""Registers, spills and SASS instruction counts of paddle_tpu_torch's
kernels, for one tree or several.

For each tree it compiles the named sources of <tree>/paddle_tpu_torch/csrc
with the port's nvcc flags and `-Xptxas -v`, reads each kernel's registers,
spill stores and loads from ptxas, counts the instructions of its SASS
(`cuobjdump -sass`) and prints one JSON line per tree. Kernels are kept
when their mangled or demangled name contains one of the --match strings.

    python3 tools/kernel_resources.py --match bwd_kernel \\
        --src fused_norm.cu --src fused_elementwise.cu build/parent .

Needs nvcc and cuobjdump (the CUDA toolkit); no card.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC']


def _tool(name):
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(home, 'bin', name)
    return path if os.path.isfile(path) else shutil.which(name)


def _demangle(names):
    if not names:
        return {}
    res = subprocess.run([_tool('cu++filt') or 'c++filt'], input='\n'.join(
        names), capture_output=True, text=True)
    return dict(zip(names, res.stdout.splitlines()))


def resources(tree, sources, match):
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            path = os.path.join(tree, 'paddle_tpu_torch', 'csrc', src)
            obj = os.path.join(tmp, src + '.o')
            res = subprocess.run([_tool('nvcc'), *NVCC_FLAGS, '-Xptxas', '-v',
                                  '-c', path, '-o', obj],
                                 capture_output=True, text=True, check=True)
            current = None
            for line in res.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    current = m.group(1)
                    out[current] = {'source': src}
                m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                              r'loads', line)
                if m and current:
                    out[current].update(spill_stores=int(m.group(1)),
                                        spill_loads=int(m.group(2)))
                m = re.search(r'Used (\d+) registers', line)
                if m and current:
                    out[current]['registers'] = int(m.group(1))
            sass = subprocess.run([_tool('cuobjdump'), '-sass', obj],
                                  capture_output=True, text=True,
                                  check=True).stdout
            current = None
            for line in sass.splitlines():
                m = re.search(r'Function : (\S+)', line)
                if m:
                    current = m.group(1)
                    out.setdefault(current, {'source': src})['sass'] = 0
                elif current and re.match(r'\s+/\*[0-9a-f]{4}\*/\s+\S', line):
                    out[current]['sass'] += 1
    names = _demangle(list(out))
    return {names.get(k, k): v for k, v in out.items()
            if any(s in k or s in names.get(k, k) for s in match)}


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument('--src', action='append', required=True)
    ap.add_argument('--match', action='append', default=[])
    ap.add_argument('trees', nargs='*', default=['.'])
    args = ap.parse_args(argv)
    for tree in args.trees:
        print(json.dumps({'tree': tree, 'kernels': resources(
            tree, args.src, args.match or [''])}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
