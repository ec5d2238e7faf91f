"""Data-parallel benchmark runner, one process per device.

Counterpart of the JAX package's ``parallel/launch.py``: join the process
group, build the mesh over every rank, load and shard the matrix, time
the sharded SpMV (plain-PyTorch row-block CSR or striped TJDS sums, the
JAX runner's default ``xla`` kernels), report. Under ``torchrun`` (the
group from its environment; NCCL on cards, gloo with ``--device cpu``):

    torchrun --standalone --nproc_per_node 4 \\
        -m smvp_toolkit_tpu_torch.parallel.launch matrix.mtx --alg csr -n 100

Without ``torchrun`` it runs as one rank. Every rank prints its y
checksum, so a run shows that the gathered y agrees across the group.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="smvp-dist", description="data-parallel SpMV benchmark runner"
    )
    ap.add_argument("file", help="input .mtx file (or synth:N:NNZ)")
    ap.add_argument("--alg", choices=["csr", "tjds"], default="csr")
    ap.add_argument("-n", "--iter", type=int, default=100)
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous address host:port (or a file:// URL) "
                         "when not under torchrun")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="run on the cards (NCCL, default) or on the CPU "
                         "(gloo)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.formats.tjds import tjds_encode
    from smvp_toolkit_tpu_torch.io.mtx import read_mtx
    from smvp_toolkit_tpu_torch.parallel.mesh import (
        device_count,
        distributed_init,
        make_mesh,
    )
    from smvp_toolkit_tpu_torch.parallel.spmv_dist import shard_and_bench
    from smvp_toolkit_tpu_torch.utils.logging import log

    distributed_init(args.coordinator, args.num_processes, args.process_id,
                     device=args.device)
    n_dev = device_count()
    mesh = make_mesh(n_dev, device=args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    is_lead = rank == 0
    if is_lead:
        log("START", f"{n_dev} process(es), {n_dev} device(s)")

    if args.file.startswith("synth:"):
        from smvp_toolkit_tpu_torch.utils.synth import parse_synth_spec

        coo = parse_synth_spec(args.file, device=mesh.device)
    else:
        coo = read_mtx(args.file, device=mesh.device)
    coo = coo.pad(512)

    x = torch.ones(coo.shape[1], dtype=torch.float32, device=mesh.device)
    alg = args.alg.upper()
    encoded = csr_encode(coo) if alg == "CSR" else tjds_encode(coo)
    stats, y = shard_and_bench(alg, encoded, x, n_dev, iterations=args.iter,
                               kernel="torch", mesh=mesh)

    if is_lead:
        nnzs = stats.nnz_per_s(coo.nnz)
        log("DATA", f"{alg} sharded over {n_dev} devices: avg "
            f"{stats.avg_ms:.4f} ms  ({nnzs/1e9:.3f} Gnnz/s aggregate)")
    log("DATA", f"y checksum [process {rank}]: {float(y.sum()):.6g}")
    if is_lead:
        log("STOP", "done")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
