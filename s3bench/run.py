"""Run one cell of the benchmark once.

    python3 s3bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration in
``s3bench/configs/<config>.json`` and its traffic mix in
``s3bench/traffic/<mix>.json``; each per-layer metric is read by
``s3bench/metrics/<metric>.py``. The server runs in this process, the
load generators are child processes, and ``lifecycle.Run`` reaps every
process the run started before the last line is printed. That line is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``,
each number compared with its limit (also the last lines on standard
error).
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import http.client  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from s3bench import lifecycle, sigv4, traffic  # noqa: E402
from s3bench import reference as ref  # noqa: E402

BUCKET = "s3bench"
SETUP_DEADLINE_S = 1100   # the first run in a checkout builds the kernels
RUN_DEADLINE_S = 320      # from the end of the build to the last line
GRACE_S = 60              # answers due in the window are awaited this long
FORBIDDEN = ("jax", "jaxlib", "flax", "minio_tpu")


class NoCard(Exception):
    pass


def load_bench(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise ValueError(f"no {what} named {name!r}")


def parity(config: dict) -> tuple[int, int]:
    p = int(config["env"]["MINIO_STORAGE_CLASS_STANDARD"].split(":")[1])
    return config["drives"] - p, p


class Window:
    """What the per-layer readers read: the program's counters at each
    edge of the window, every request's record, the device trace."""

    def __init__(self, config, before, after, records, trace, seconds=0.0):
        self.before, self.after, self.records, self.trace = before, after, records, trace
        self.seconds = seconds
        self.d, self.p = parity(config)

    def delta(self, *path) -> float:
        a, b = self.after, self.before
        for k in path:
            a, b = a.get(k, {}), b.get(k, {})
        return (a or 0) - (b or 0)

    def shapes(self, kernel: str) -> dict:
        """Launches by shape made in the window, from the kernel's
        counter of launch shapes."""
        b = {tuple(map(_tup, k)): n for k, n in self.before[kernel]["shapes"]}
        out = {}
        for k, n in self.after[kernel]["shapes"]:
            k = tuple(map(_tup, k))
            if n - b.get(k, 0):
                out[k] = n - b.get(k, 0)
        return out


def _tup(x):
    return tuple(x) if isinstance(x, list) else x


def read_metric(name: str, w: Window):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"s3bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(w)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--benchmark", default="BENCHMARK.json",
                    help="the benchmark file (tests give their own)")
    ap.add_argument("--fault", default="",
                    help="plant a fault or run the control (s3bench/faults.py); "
                         "never given by the benchmark's own runs")
    ap.add_argument("--cpu", action="store_true",
                    help="tests only: skip the look for a card and run the "
                         "configuration's CPU route")
    return ap.parse_args(argv)


def spawn_generators(run: lifecycle.Run, n: int) -> list[subprocess.Popen]:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return [run.spawn([sys.executable, "-m", "s3bench.gen"], cwd=ROOT, env=env,
                      stdin=subprocess.PIPE, stdout=subprocess.PIPE) for _ in range(n)]


def request(port: int, method: str, path: str, body: bytes = b"", headers=None):
    return sigv4.send(port, sigv4.Request(f"127.0.0.1:{port}", method, path, body,
                                          headers=headers))


def put_many(port: int, items: list[tuple[str, int]], seed: int, size: int, cls: str,
             threads: int) -> None:
    """Set-up PUTs (the warm-up), ``threads`` at a time."""
    def one(item):
        key, i = item
        data = traffic.body(seed, i, size)
        status, headers, body = request(port, "PUT", f"/{BUCKET}/{key}", data,
                                        {"x-amz-storage-class": cls})
        if status != 200 or headers.get("etag", "").strip('"') != hashlib.md5(data).hexdigest():
            raise RuntimeError(f"set-up PUT {key}: {status} {body[:200]!r}")

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, items))


def read_back(port: int, objects: list[tuple[str, int]], seed: int, size: int) -> int:
    """Acknowledged objects whose GET does not return the body sent
    within ``GRACE_S`` for all of them: a GET refused, cut off or still
    unanswered then returns nothing."""
    wrong = 0
    end = time.monotonic() + GRACE_S
    for key, i in objects:
        status, body = -1, b""
        if (left := end - time.monotonic()) > 0:
            req = sigv4.Request(f"127.0.0.1:{port}", "GET", f"/{BUCKET}/{key}")
            try:
                status, _, body = sigv4.send(port, req, timeout=left)
            except (OSError, http.client.HTTPException) as e:
                print(f"s3bench: read-back GET {key}: {e!r}", file=sys.stderr, flush=True)
        wrong += status != 200 or body != traffic.body(seed, i, size)
    return wrong


def fail_drives(drives: list[str], which: list[int]) -> None:
    """Make drives unreachable as a failed drive is: the directory goes
    aside and a plain file takes its path, so every access there fails
    with an I/O error and nothing can be written."""
    for i in which:
        os.rename(drives[i], drives[i] + ".failed")
        open(drives[i], "wb").close()


def restore_drives(drives: list[str], which: list[int]) -> None:
    for i in which:
        os.remove(drives[i])
        os.rename(drives[i] + ".failed", drives[i])


def remove(path: str) -> None:
    """Remove the run's scratch directory, saying what could not go."""
    def report(func, p, exc):
        print(f"s3bench: could not remove {p}: {exc!r}", file=sys.stderr, flush=True)

    shutil.rmtree(path, onexc=report)


def collect(gens: list[subprocess.Popen], timeout: float) -> list:
    out = []
    end = time.monotonic() + timeout
    for g in gens:
        stdout, _ = g.communicate(timeout=max(1.0, end - time.monotonic()))
        if g.returncode != 0:
            raise RuntimeError(f"load generator {g.pid} exited {g.returncode}")
        out += json.loads(stdout)["records"]
    return out


def shard_check(drives: list[str], key: str, data: bytes, d: int, p: int) -> int:
    """Shard files of one object that do not match the reference: each
    of the d + p reference files must be on exactly one drive."""
    want = {hashlib.sha256(f).digest(): i for i, f in enumerate(ref.shard_files(data, d, p))}
    seen: dict[int, int] = {}
    for drv in drives:
        parts = []
        obj_dir = os.path.join(drv, BUCKET, key)
        if os.path.isdir(obj_dir):
            parts = [os.path.join(obj_dir, e, "part.1") for e in os.listdir(obj_dir)
                     if os.path.isfile(os.path.join(obj_dir, e, "part.1"))]
        for path in parts:
            with open(path, "rb") as f:
                idx = want.get(hashlib.sha256(f.read()).digest())
            if idx is not None:
                seen[idx] = seen.get(idx, 0) + 1
    return sum(1 for i in range(d + p) if seen.get(i) != 1)


def execute(run: lifecycle.Run, args) -> dict:
    bench = load_bench(args.benchmark)
    bench_dir = os.path.dirname(os.path.abspath(args.benchmark))
    cell = find(bench["workloads"], args.workload, "workload")
    cfg_entry = find(bench["configs"], cell["config"], "configuration")
    with open(os.path.join(bench_dir, cfg_entry["file"])) as f:
        config = json.load(f)
    mix_dir = os.path.join(bench_dir, bench.get("traffic_dir", "s3bench/traffic"))
    with open(os.path.join(mix_dir, f"{cell['traffic']}.json")) as f:
        mix = json.load(f)

    import torch

    if not args.cpu:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"the cell needs {cell['chips']} CUDA card(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    os.environ.update(config["env"])
    d, p = parity(config)
    seconds, seed, size = args.seconds, args.seed, mix["object_bytes"]
    traffic.check_budget(mix, d, p)

    scratch = tempfile.mkdtemp(prefix="s3bench-")
    run.stops.append(lambda: remove(scratch))
    drives = [os.path.join(scratch, f"d{i}") for i in range(config["drives"])]
    gens = spawn_generators(run, mix["generators"])

    from s3bench import faults, program

    # the control breaks the deployment from the start; a fault is
    # planted in the write path once the server is up
    control = args.fault == "control"
    fault = "" if control else args.fault
    if control:
        faults.plant("control", config)
    if not args.cpu:
        program.build_kernels()
        run.set_deadline(RUN_DEADLINE_S)
    srv, port, stop = program.start(drives)
    run.stops.insert(0, stop)
    status, _, body = request(port, "PUT", f"/{BUCKET}")
    if status != 200:
        raise RuntimeError(f"make bucket: {status} {body[:200]!r}")

    cls = mix.get("storage_class", "STANDARD")
    faults.plant(fault, config)
    put_many(port, [(f"warm-{i}", 10 ** 9 + i) for i in range(mix["warm_puts"])], seed,
             size, cls, mix["warm_puts"])

    # the jobs: the window opens when the generators have them
    jobs = [{"port": port, "bucket": BUCKET, "seed": seed, "seconds": seconds,
             "object_bytes": size, "storage_class": cls,
             "request_timeout_s": GRACE_S + seconds, "clients_total": mix["clients"],
             "max_objects": mix["max_objects"],
             "clients": list(range(g, mix["clients"], len(gens)))} for g in range(len(gens))]

    # the card's activity is traced in every run on the card: the
    # end-to-end metric reads its kernels, the per-layer readers the rest
    tracer = None
    if not args.cpu:
        from s3bench.devtrace import DeviceTrace

        tracer = DeviceTrace(scratch)
        tracer.start()
    if not args.cpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = program.counters(srv)
    t0 = time.monotonic() + 0.2
    for g, job in zip(gens, jobs):
        job["t0"] = t0
        g.stdin.write(json.dumps(job).encode())
        g.stdin.close()
        g.stdin = None  # communicate() reads the records later
    setup_s = t0 - T_START
    time.sleep(max(0.0, t0 + seconds - time.monotonic()))
    # the window closes: the clients send nothing more, every PUT they
    # sent is awaited, and the trace and the counters end after that, so
    # that they cover the same work
    records = collect(gens, GRACE_S + 30)
    if tracer is not None:
        tracer.stop()
    after = program.counters(srv)
    peak = torch.cuda.max_memory_allocated() if not args.cpu else 0
    device = {"platform": "cpu" if args.cpu else "gpu",
              "kind": "cpu" if args.cpu else torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if tracer is not None:
        print(f"s3bench: the card ran kernels {tracer.kernel_s():.6f} s, all operations "
              f"{tracer.busy_s():.6f} s, in a traced {tracer.window_s:.6f} s",
              file=sys.stderr, flush=True)
    if args.trace and tracer is not None:
        device["busy_s"] = tracer.busy_s()
        device["window_s"] = tracer.window_s

    # -- the comparison with the reference --------------------------------
    window = [r for r in records if r[4] is not None and r[4] <= seconds]
    if len(records) >= mix["max_objects"]:
        # the write cap ends the work early: the rate over the window is
        # then the cap's, max_objects over the window's seconds
        print(f"s3bench: the clients wrote all {mix['max_objects']} objects before the "
              "window closed", file=sys.stderr, flush=True)
    answered = [r for r in records if r[4] is not None]
    ok = [r for r in answered if r[5] == 200]
    checks: dict = {}
    checks["put_etag_wrong"] = sum(1 for r in ok if not r[7])
    checks["unanswered"] = len(records) - len(answered)
    checks["request_failed"] = len(answered) - len(ok)
    acked = sorted((r[1], int(r[1].rsplit("-", 1)[1])) for r in ok if r[7])
    sampled = traffic.sample(seed, acked, mix["sample_objects"])
    checks["objects_sampled"] = len(sampled)
    checks["shard_wrong"] = sum(shard_check(drives, k, traffic.body(seed, i, size), d, p)
                                for k, i in sampled)
    # the stated durability: with any p drives lost every object reads;
    # read degraded first, while no cache holds the objects
    lost = traffic.lost_drives(seed, config["drives"], p)
    fail_drives(drives, lost)
    checks["get_wrong_p_lost"] = read_back(port, sampled, seed, size)
    restore_drives(drives, lost)
    checks["get_wrong"] = read_back(port, sampled, seed, size)
    # the window ran on the route the configuration states: no fault
    # moved the program off it, and its kernels launched
    final = program.counters(srv)
    for k in ("fused_failures", "device_faults", "demotions") + \
            (() if args.cpu else ("numpy_blocks",)):
        checks[f"dispatch_{k}"] = final["dispatch"].get(k, 0) - before["dispatch"].get(k, 0)
    for path in ([] if args.cpu else config.get("launches", [])):
        kernel, counter = path.split(".")
        checks[f"{kernel}_{counter}"] = after[kernel][counter] - before[kernel][counter]

    # -- the metrics -------------------------------------------------------
    metrics: dict = {}
    if args.trace:
        w = Window(config, before, after, window, tracer, seconds)
        for m in bench["per_layer"]:
            if m.get("workloads") is not None and cell["name"] not in m["workloads"]:
                continue
            v = read_metric(m["name"], w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = e2e(records, setup_s, tracer)
        for m in bench["end_to_end"]:
            if m.get("workloads") is not None and cell["name"] not in m["workloads"]:
                continue
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    out = {"correct": all(c["ok"] for c in judge(checks).values()),
           "attempted": len(window),
           "failed": sum(1 for r in window if r[5] != 200),
           "metrics": metrics, "device": device}
    if args.trace and tracer is not None:
        out["breakdown"] = tracer.breakdown()
    out["checks"] = {k: {x: c[x] for x in ("value", "limit", "rule")}
                     for k, c in judge(checks).items()}
    return out


def judge(checks: dict) -> dict:
    """Each number compared with its limit: the objects sampled and each
    kernel's launches at least 1, every other number at most 0."""
    out = {}
    for k, v in checks.items():
        least = k == "objects_sampled" or k.endswith("_launches")
        out[k] = {"value": v, "limit": 1 if least else 0,
                  "rule": "at least" if least else "at most",
                  "ok": v >= 1 if least else v <= 0}
    return out


def e2e(records: list, setup_s: float, trace) -> dict:
    """The end-to-end metrics. ``card_ms_per_gib.put``: the card's kernel
    time from the window's start until every PUT sent in it was
    answered, over the GiB of those PUTs that were acknowledged."""
    out = {"setup_s": setup_s}
    acked = sum(r[6] for r in records if r[5] == 200)
    if trace is not None and acked:
        out["card_ms_per_gib.put"] = trace.kernel_s() * 1e3 / (acked / (1 << 30))
    return out


def main(argv=None) -> None:
    args = parse(argv)
    run = lifecycle.Run()
    run.install()
    run.set_deadline(SETUP_DEADLINE_S)
    result, code = None, 1
    try:
        result = execute(run, args)
        code = 0
    except NoCard as e:
        print(f"s3bench: {e}", file=sys.stderr, flush=True)
        code = 2
    except lifecycle.Stopped as e:
        print(f"s3bench: stopped by {e}", file=sys.stderr, flush=True)
        code = 3
    except Exception:  # noqa: BLE001 — the run ends here, and is reported
        traceback.print_exc()
        code = 1
    finally:
        left = run.finish()
    if left:
        print(f"s3bench: {len(left)} process(es) could not be reaped: {left}", file=sys.stderr)
    if result is not None:
        loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
        if loaded:
            print(f"s3bench: the run loaded {loaded}", file=sys.stderr, flush=True)
            result, code = None, 4
    if result is not None:
        if left:
            result["correct"] = False
        result["checks"]["processes_left"] = {"value": len(left), "limit": 0, "rule": "at most"}
        result["checks"] = result.pop("checks")
        for k, v in result["checks"].items():
            print(f"check {k}: {v['value']} ({v['rule']} {v['limit']})", file=sys.stderr)
        sys.stderr.flush()
        sys.stdout.write(json.dumps(result) + "\n")
        sys.stdout.flush()
    os._exit(code)


if __name__ == "__main__":
    main()
