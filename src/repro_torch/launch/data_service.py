"""Data-service launcher: K concurrent training jobs over ONE chunk cache.

    PYTHONPATH=src python -m repro.launch.data_service --jobs 3 --epochs 1

Builds a synthetic chunk store (or reuses ``--store-dir``), opens one
session per job on a :class:`repro.service.DataService`, drives the shared
round-robin pump, and reports per-job + aggregate sharing stats: with K
co-scheduled jobs the bytes actually read from storage stay close to 1x the
dataset while the protocol-level demand is ~K x (every duplicate chunk read
is served from the shared residency).

With ``--serve SOCKET`` it instead exposes the service out-of-process:
trainers in other OS processes open sessions over the unix socket
(``repro.launch.train --data-server SOCKET``) and batches flow through
per-session shared-memory rings (DESIGN.md §11).
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
import time
from pathlib import Path

from ..core import ChunkStore, SessionSpec
from ..core.storage import make_backend
from ..data import SyntheticTokenDataset
from ..obs import attribution, format_report, trace
from ..service import AdmissionControl, DataService
from ..service.transport import DataServiceServer
from ..service.transport.server import service_metrics
from .cli import (
    add_autotune_args,
    add_data_plane_args,
    add_elastic_args,
    add_obs_args,
    resolve_resume_dir,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--groups", type=int, default=8)
    add_data_plane_args(ap, batch=16, seq_len=64, num_docs=512)
    ap.add_argument("--co-refill", action="store_true",
                    help="steer refill tie-breaks toward shareable chunks")
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="shared residency cap in MB (default: unbounded)")
    ap.add_argument("--eviction", choices=["belady", "lru"], default="belady",
                    help="cache eviction under --cache-mb: clairvoyant "
                         "Belady/MIN over the merged claim schedule "
                         "(default) or plain least-recently-claimed")
    add_autotune_args(ap)
    ap.add_argument("--admission-mb-s", type=float, default=None,
                    metavar="MB/S",
                    help="storage bandwidth budget for open_session "
                         "admission control (default with --autotune: the "
                         "calibrated bandwidth of the chosen backend)")
    ap.add_argument("--admission-mode", choices=["reject", "queue"],
                    default=None,
                    help="what an over-budget open_session gets: an "
                         "immediate AdmissionRejected, or queueing until "
                         "capacity frees (enables admission control)")
    ap.add_argument("--store-dir", type=Path, default=None,
                    help="reuse/build the chunk store here instead of a tmpdir")
    add_elastic_args(ap)
    add_obs_args(ap)
    ap.add_argument("--serve", metavar="SOCKET", default=None,
                    help="serve sessions out-of-process on this unix socket "
                         "instead of pumping local jobs (trainers connect "
                         "with repro_torch.launch.train --data-server SOCKET)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    resume_dir = resolve_resume_dir(ap, args.resume_data, None)
    if args.suspend_after is not None and resume_dir is None:
        ap.error("--suspend-after requires --resume-data DIR")
    if resume_dir is not None and args.store_dir is None:
        ap.error("--resume-data requires --store-dir (the snapshot references "
                 "the persistent chunk store)")
    if args.serve is not None and args.suspend_after is not None:
        ap.error("--suspend-after is driven over the socket when serving "
                 "(RedoxClient.suspend)")
    tracer = trace.enable(args.trace_capacity) if args.trace else None

    with contextlib.ExitStack() as stack:
        if args.store_dir is None:
            tmp = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="redox_svc_")
            )
            root = Path(tmp) / "chunks"
        else:
            root = args.store_dir
        if not (root / "plan.npz").exists():
            ds = SyntheticTokenDataset(
                args.num_docs, vocab_size=args.vocab_size or 32000,
                mean_len=args.seq_len, seed=args.seed + 5,
            )
            ds.build_store(
                root, args.chunk_size,
                num_slots=args.groups * args.chunk_size, seed=args.seed,
                codec=args.codec, bands=args.bands,
            ).close()
        limit = int(args.cache_mb * 1e6) if args.cache_mb else None
        tuned_bw = None
        fidelity = args.fidelity
        if args.autotune:
            from .. import autotune

            _, choice = autotune.tune_store(
                root,
                compute_per_step_s=args.compute_per_step,
                num_steps=max(args.num_docs // max(args.batch, 1), 1),
                memory_limit_bytes=(
                    int(args.autotune_memory_mb * 1e6)
                    if args.autotune_memory_mb is not None else None
                ),
            )
            print(f"autotune: {choice.describe()}")
            tuned_bw = choice.model.disk_bw
            if args.backend is None:
                kw = {"readahead": choice.readahead} if choice.readahead else {}
                store = ChunkStore.open(
                    root, backend=make_backend(choice.backend, **kw)
                )
            else:
                store = ChunkStore.open(root, backend=args.backend)
            if limit is None:
                limit = choice.cache_limit_bytes
            if fidelity is None:
                fidelity = choice.fidelity
        else:
            store = ChunkStore.open(root, backend=args.backend or "vfs")
        admission = None
        if args.admission_mb_s is not None or args.admission_mode is not None:
            bw = (
                args.admission_mb_s * 1e6
                if args.admission_mb_s is not None else tuned_bw
            )
            if bw is None:
                ap.error("--admission-mode needs --admission-mb-s or "
                         "--autotune (to measure the bandwidth budget)")
            if args.compute_per_step <= 0:
                ap.error("admission control needs --compute-per-step > 0 "
                         "(predicted read rate is bytes per compute-second)")
            admission = AdmissionControl(
                bandwidth_bytes_per_s=bw,
                compute_per_step_s=args.compute_per_step,
                mode=args.admission_mode or "reject",
            )
            print(f"admission: {admission.mode} over "
                  f"{bw / 1e6:.1f} MB/s budget")
        resuming = (
            resume_dir is not None
            and (resume_dir / "service_manifest.json").exists()
        )
        if resuming:
            svc = DataService.resume(resume_dir, store)
            start_epoch = min(
                s.loader.resume_point[0] for s in svc.sessions
                if s.loader.resume_point is not None
            )
            print(f"resumed {len(svc.sessions)} session(s) mid-epoch "
                  f"{start_epoch} from {resume_dir}")
        else:
            svc = DataService(store, cache_limit_bytes=limit,
                              co_refill=args.co_refill,
                              eviction=args.eviction,
                              admission=admission)
            start_epoch = 0

        if args.serve is not None:
            # Serve mode: sessions come from the clients (or the resumed
            # snapshot), not from --jobs.
            with DataServiceServer(svc, args.serve) as server:
                print(f"serving on {args.serve} "
                      f"({len(svc.sessions)} resumed session(s), "
                      f"ctrl-c to stop; scrape with the metrics/trace_dump "
                      f"RPCs)", flush=True)
                with contextlib.suppress(KeyboardInterrupt):
                    server.serve_forever()
                if args.metrics:
                    print(server.metrics.exposition(), end="")
            if tracer is not None:
                out = tracer.dump(args.trace)
                print(f"trace: {len(tracer)} events -> {out}")
            store.close()
            return 0

        if not resuming:
            for j in range(args.jobs):
                svc.open_session(f"job{j}", SessionSpec(
                    policy=args.policy, seed=args.seed + 10 * j + 1,
                    batch_per_node=args.batch, seq_len=args.seq_len,
                    engine=args.engine, fidelity=fidelity,
                ))
        steps = {s.job_id: 0 for s in svc.sessions}
        demand = 0
        pumped = 0
        suspended = False
        t0 = time.perf_counter()
        for epoch in range(start_epoch, args.epochs):
            pump = svc.co_epoch(epoch)
            for job_id, _ in pump:
                steps[job_id] += 1
                pumped += 1
                if args.suspend_after is not None and pumped >= args.suspend_after:
                    suspended = True
                    break
            if suspended:
                pump.close()
                out = svc.suspend(resume_dir)
                print(f"suspended after {pumped} pump step(s) -> {out}; "
                      f"rerun with the same flags to continue")
                break
            # NodeStats are per-epoch (reset at the next begin_epoch), so
            # fold each epoch's protocol-level demand in as it completes.
            demand += sum(
                n.stats.disk_bytes for s in svc.sessions for n in s.cluster.nodes
            )
        wall = time.perf_counter() - t0

        rep = svc.stats_report()
        agg = rep["aggregate"]
        print(f"{args.jobs} jobs x {args.epochs} epoch(s), engine={args.engine}, "
              f"co_refill={args.co_refill}: {sum(steps.values())} steps "
              f"in {wall:.2f}s")
        for job_id in sorted(rep["per_job"]):
            st = rep["per_job"][job_id]
            print(f"  {job_id}: steps={steps[job_id]} "
                  f"physical={st['physical_bytes']/1e6:.1f}MB "
                  f"shared={st['shared_bytes']/1e6:.1f}MB "
                  f"(hits={st['shared_hits']}, co_refill={st['co_refill_hits']})")
        saved = agg["shared_bytes"]
        svc_rec = rep["service"]
        print(f"aggregate: demand={demand/1e6:.1f}MB "
              f"physical={agg['physical_bytes']/1e6:.1f}MB "
              f"dup_loads_avoided={agg['dup_loads_avoided']} "
              f"saved={saved/1e6:.1f}MB "
              f"peak_cache={svc_rec['peak_cache_bytes']/1e6:.1f}MB "
              f"evictions={svc_rec['evictions']} "
              f"({svc_rec['eviction']}, bypass={svc_rec['cache_bypass']})")
        if args.metrics:
            reg = service_metrics(svc)
            for j, st in svc.residency.per_job_stats.items():
                reg.register_stats(
                    "service", lambda st=st: st, labels={"job": str(j)}
                )
            print(reg.exposition(), end="")
        if tracer is not None:
            out = tracer.dump(args.trace)
            print(f"trace: {len(tracer)} events ({tracer.dropped} dropped) "
                  f"-> {out}; open in the Perfetto UI or chrome://tracing")
            print(format_report(
                attribution(tracer.events(), wall_s=wall),
                measured_wall_s=wall,
            ))
            trace.disable()
        svc.close()
        store.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
