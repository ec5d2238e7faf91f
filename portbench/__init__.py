"""The benchmark of the PyTorch and CUDA port (``smvp_toolkit_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the first CUDA
device and prints one JSON line as the last line of standard output.

Everything a cell needs is found by name, so a cell, a configuration, a
traffic mix or a metric is added by adding files:

* ``configs/<config>.json``: a deployment (a matrix), its source and the
  generator that makes it (``generators/<generator>.py``) from the seed;
* ``mixes/<traffic>.json``: the traffic, parameters only; it names the
  entry of the port that it drives (``entries/<entry>.py``);
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct``;
* ``metrics/<metric>.py``: one reader per metric, end-to-end or per layer.

The plain float64 reference is in ``reference/``; the byte counts of the
rooflines in ``needed_bytes.py``, the device peaks in ``peaks.json``.
Nothing here imports JAX or the JAX package.
"""
