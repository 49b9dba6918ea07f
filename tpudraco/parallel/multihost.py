"""Multi-host corpus driver (SURVEY.md §2.9 / §5.8).

The corpus is the natural shard axis: each host owns a deterministic slice
(round-robin by index so sizes balance), encodes its slice with the
device-batched BatchEncoder, and rank 0 concatenates per-host reports.
Collectives ride the JAX distributed runtime (the network between hosts,
NVLink between the cards of one host); bitstream order is preserved
because each output file is self-contained and named by its input.

Single-process (tests, one host) degenerates to the plain batch driver.
"""

from __future__ import annotations

import json
import os


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids: list[int] | None = None
                     ) -> tuple[int, int]:
    """Initialize jax.distributed when run under a multi-host launcher;
    returns (process_id, num_processes). No-ops on a single host.

    Unset arguments come from JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES
    and JAX_PROCESS_ID. Processes that share one host (a localhost
    coordinator) each take one card, the one numbered ``process_id``,
    unless ``local_device_ids`` says otherwise: a JAX process reserves
    most of every card it opens, so two on one card would fail. Processes
    on separate hosts keep all their local cards."""
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator:
        if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
            num_processes = int(os.environ["JAX_NUM_PROCESSES"])
        if process_id is None and os.environ.get("JAX_PROCESS_ID"):
            process_id = int(os.environ["JAX_PROCESS_ID"])
        host = coordinator.rsplit(":", 1)[0]
        if (local_device_ids is None and process_id is not None
                and host in ("localhost", "127.0.0.1", "[::1]")):
            local_device_ids = [process_id]
        jax.distributed.initialize(
            coordinator_address=coordinator, num_processes=num_processes,
            process_id=process_id, local_device_ids=local_device_ids)
    return jax.process_index(), jax.process_count()


def shard_corpus(inputs: list[str], process_id: int,
                 num_processes: int) -> list[str]:
    """Deterministic round-robin slice of the corpus for this host."""
    return [p for i, p in enumerate(sorted(inputs))
            if i % num_processes == process_id]


def encode_corpus_multihost(inputs: list[str], out_dir: str,
                            resume: bool = True,
                            use_device: bool | str = False,
                            workers: int = 1, cfg=None) -> dict:
    """Encode a corpus across all participating hosts. Every host writes
    its own outputs (shared filesystem or per-host dirs both work); the
    merged report is returned on every host, with cross-host totals
    all-reduced via a tiny psum when more than one process participates."""
    import jax
    import numpy as np
    from jax.experimental import multihost_utils

    from .batch import BatchEncoder

    pid, nproc = jax.process_index(), jax.process_count()
    mine = shard_corpus(inputs, pid, nproc)
    report = BatchEncoder(use_device=use_device, cfg=cfg).encode_corpus(
        mine, out_dir, resume=resume, workers=workers)

    if nproc > 1:
        # aggregate counters across hosts (one all-gather of a 4-vector);
        # float64 is exact to 2^53 and avoids the silent int64->int32
        # downcast jnp applies without jax_enable_x64 (byte totals of
        # multi-GiB corpora overflow int32)
        local = np.asarray([report["encoded"], report["skipped"],
                            report["total_in_bytes"],
                            report["total_out_bytes"]], dtype=np.float64)
        totals = np.asarray(multihost_utils.process_allgather(local))
        agg = totals.reshape(nproc, 4).sum(axis=0)
        report = dict(report)
        report["encoded"] = int(agg[0])
        report["skipped"] = int(agg[1])
        report["total_in_bytes"] = int(agg[2])
        report["total_out_bytes"] = int(agg[3])
        report["num_hosts"] = int(nproc)
    if pid == 0:
        tmp_rep = os.path.join(out_dir, f"corpus_report.json.tmp{os.getpid()}")
        with open(tmp_rep, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp_rep, os.path.join(out_dir, "corpus_report.json"))
    return report
