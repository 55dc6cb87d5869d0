"""The benchmark's parts on the CPU: traffic from the seed, metrics over
every request, the plain reference against fixed vectors, the modules it
imports, and BENCHMARK.json against the contract's limits."""

import ast
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
sys.path.insert(0, ROOT)

from s3bench import reference as ref  # noqa: E402
from s3bench import run, traffic  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "minio_tpu"}


# -- traffic -----------------------------------------------------------------

def test_same_seed_same_schedule_and_bodies():
    assert traffic.body(2 ** 31 + 7, 3, 1 << 20) == traffic.body(2 ** 31 + 7, 3, 1 << 20)
    assert traffic.body(2 ** 31 + 7, 3, 1000) != traffic.body(2 ** 31 + 8, 3, 1000)
    assert len(traffic.body(5, 0, 10 * (1 << 20) + 3)) == 10 * (1 << 20) + 3
    assert traffic.object_key("put", 2 ** 33 + 1, 7) == "put-8589934593-000007"


def test_seeds_share_the_work_in_another_order():
    # every seed loses p distinct drives of the set for the read-back
    a, b = traffic.lost_drives(2 ** 31 + 1, 16, 8), traffic.lost_drives(2 ** 32 + 5, 16, 8)
    assert a == traffic.lost_drives(2 ** 31 + 1, 16, 8)
    assert len(set(a)) == len(set(b)) == 8 and a != b
    assert all(0 <= i < 16 for i in a + b)


def test_sample_is_drawn_from_the_seed():
    pop = list(range(100))
    assert traffic.sample(9, pop, 8) == traffic.sample(9, pop, 8)
    assert len(set(traffic.sample(9, pop, 8))) == 8
    assert traffic.sample(9, pop[:3], 8) == pop[:3]


def test_budget_counts_every_shard_byte():
    assert traffic.shard_bytes(1 << 20, 8, 8) == 16 * ((1 << 17) + 32)
    assert traffic.shard_bytes(10 << 20, 12, 4) == 10 * 16 * (87382 + 32)
    mix = {"object_bytes": 10 << 20, "max_objects": 300, "warm_puts": 0,
           "max_written_bytes": 3 << 30}
    with pytest.raises(ValueError):
        traffic.check_budget(mix, 12, 4)
    small = {**mix, "max_objects": 1500, "warm_puts": 20, "object_bytes": 1 << 20}
    assert traffic.check_budget(small, 8, 8) == 1520 * traffic.shard_bytes(1 << 20, 8, 8)


# -- metrics over every request of the window ---------------------------------

def _rec(done, status=200, nbytes=1 << 20):
    return ["put", "k", 0.0, 0.0, done, status, nbytes, True]


def test_put_percentiles_take_every_request():
    recs = [_rec((i + 1) / 1000) for i in range(100)]
    w = run.Window({"env": {"MINIO_STORAGE_CLASS_STANDARD": "EC:8"}, "drives": 16},
                   {}, {}, recs, None)
    assert run.read_metric("client_p50_ms.put", w) == pytest.approx(50)
    assert run.read_metric("client_p95_ms.put", w) == pytest.approx(95)
    # a PUT refused misses every limit
    recs[0][5] = 503
    assert run.read_metric("client_p95_ms.put", w) == pytest.approx(96)


def test_closed_loop_rate_is_bytes_completed_over_the_window():
    recs = [_rec(0.01 * (i + 1)) for i in range(100)]
    recs.append(_rec(0.5, status=500))
    w = run.Window({"env": {"MINIO_STORAGE_CLASS_STANDARD": "EC:8"}, "drives": 16},
                   {}, {}, recs, None, 2.0)
    assert run.read_metric("client_mib_s.put", w) == pytest.approx(50.0)


class _Trace:
    def __init__(self, ops):
        from s3bench.devtrace import DeviceTrace

        self.t = DeviceTrace("")
        self.t.ops = ops

    def kernel_s(self):
        return self.t.kernel_s()


def test_card_cost_is_every_kernel_over_every_acknowledged_put():
    # 1,024 acknowledged MiB and one refused PUT; copies are not kernels
    recs = [_rec(0.01 * (i + 1)) for i in range(1024)] + [_rec(0.5, status=500)]
    trace = _Trace([("gf_core_kernel", 0.0, 0.25, "kernel"),
                    ("hh_ring_kernel<FusedRows>", 0.3, 0.05, "kernel"),
                    ("Memcpy HtoD (Pageable -> Device)", 0.4, 2.0, "gpu_memcpy")])
    out = run.e2e(recs, 1.0, trace)
    assert out == {"setup_s": 1.0, "card_ms_per_gib.put": pytest.approx(300.0)}
    # without the card's trace (the CPU route) there is no card cost
    assert run.e2e(recs, 1.0, None) == {"setup_s": 1.0}


@pytest.mark.parametrize("name,value,ok", [
    ("shard_wrong", 0, True), ("shard_wrong", 1, False),
    ("get_wrong_p_lost", 1, False), ("dispatch_demotions", 1, False),
    ("dispatch_numpy_blocks", 3, False), ("k1_encode_launches", 0, False),
    ("k1_encode_launches", 12, True), ("objects_sampled", 0, False),
])
def test_each_number_is_held_to_its_limit(name, value, ok):
    got = run.judge({name: value})[name]
    assert got["ok"] is ok
    assert got["rule"] == ("at least" if name in ("k1_encode_launches", "objects_sampled")
                           else "at most")


def test_percentile_is_nearest_rank():
    assert traffic.percentile([3, 1, 2], 50) == 2
    assert traffic.percentile(list(range(1, 101)), 99) == 99
    assert traffic.percentile([7], 95) == 7


# -- the plain reference -------------------------------------------------------

def test_minio_key_is_the_hash_of_pi():
    pi = "1415926535897932384626433832795028841971693993751058209749445923078164062862089986280348253421170679"
    digest = ref.highwayhash256(np.frombuffer(pi.encode(), dtype=np.uint8)[None], bytes(32))
    assert digest[0].tobytes() == ref.MINIO_KEY


@pytest.mark.parametrize("data,key,want", [
    (b"", ref.MINIO_KEY, "5e76d207cf4ab20866fdc03c83e8a0f4e8f458e880777956ec0bae4e9f23f6c5"),
    (bytes(range(64)), ref.MINIO_KEY,
     "8c8b584226c40f7286e247d70d013bba9a4b56a4be68efb96b0901a1842c2694"),
    (bytes(range(33)), bytes(range(32)),
     "e5a634f0cb1501f6d046cebf75ea366c90597282d3c8173b357a0011eda2da7e"),
])
def test_highwayhash_vectors(data, key, want):
    got = ref.highwayhash256(np.frombuffer(data, dtype=np.uint8)[None], key)
    assert got[0].tobytes().hex() == want


def test_highwayhash_rows_are_independent():
    rng = np.random.default_rng(1)
    for n in (1, 4, 17, 31, 32, 33, 100):
        m = rng.integers(0, 256, (3, n), dtype=np.uint8)
        both = ref.highwayhash256(m)
        for i in range(3):
            assert np.array_equal(both[i], ref.highwayhash256(m[i:i + 1])[0])


@pytest.mark.parametrize("d,p,row,want", [
    (8, 8, [26, 132, 186, 51, 231, 16, 198, 39],
     "48423b87b9bc14e23893473254767c9a91d1717e1e72486e918045691d6e871e"),
    (12, 4, [175, 180, 150, 140, 245, 232, 196, 216, 27, 28, 18, 20],
     "9a6ce95231837f20737d4581d70f2471ab1f4ccb3e5fb324fc726168f8236e19"),
])
def test_shard_files_vectors(d, p, row, want):
    assert ref.parity_rows(d, p)[0].tolist() == row
    data = bytes((i * 7 + 3) % 251 for i in range((1 << 20) + 1000))
    files = ref.shard_files(data, d, p)
    assert len(files) == d + p
    assert hashlib.sha256(b"".join(files)).hexdigest() == want


def test_rs_recovers_from_any_p_losses():
    rng = np.random.default_rng(2)
    d, p = 12, 4
    data = rng.integers(0, 256, (d, 64), dtype=np.uint8)
    full = np.concatenate([data, ref.rs_encode(data, p)])
    m = ref.rs_matrix(d, p)
    keep = [0, 2, 3, 5, 6, 7, 9, 10, 11, 12, 13, 15]
    inv = ref.gf_invert(m[keep])
    rebuilt = np.zeros_like(data)
    for i in range(d):
        for j, r in enumerate(keep):
            rebuilt[i] ^= ref.MUL[int(inv[i, j])][full[r]]
    assert np.array_equal(rebuilt, data)


# -- imports -------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for base, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(base, f))}
                assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


def test_harness_and_reference_load_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import s3bench.run, s3bench.gen, s3bench.reference, s3bench.devtrace\n"
            "import s3bench.roofline, s3bench.faults, s3bench.program\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    assert not set(json.loads(out.replace("'", '"'))) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    tops = {m.split(".")[0] for m in _imports(os.path.join(PKG, "reference.py"))}
    assert tops <= {"__future__", "hashlib", "numpy"}


# -- BENCHMARK.json ------------------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = []
    for c in b["configs"]:
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names), names
    for group in (b["configs"], b["workloads"], b["end_to_end"] + b["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)


def test_benchmark_finds_every_part_by_name():
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert os.path.isfile(os.path.join(PKG, "traffic", f"{w['traffic']}.json"))
        assert w["chips"] == 1
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(PKG, "metrics", f"{m['name']}.py"))
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", cells)
    for cell in cells:
        assert any(cell in m["workloads"] for m in b["per_layer"])
        assert any(m["name"] != "setup_s" and cell in m.get("workloads", cells)
                   for m in b["end_to_end"])
