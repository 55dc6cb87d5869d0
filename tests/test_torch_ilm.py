"""minio_tpu_torch ILM against the JAX package, on the CPU.

- ``ilm.lifecycle``: ``parse_lifecycle``, ``validate_lifecycle``,
  ``eval_action`` and ``transition_tier_for`` agree on generated rule sets
  (IDs, enabled and disabled rules, legacy and filter prefixes, tag
  filters, expiry by days and by date, delete markers, noncurrent
  versions, transitions) and generated object states (hypothesis, fixed
  seed, a fixed clock);
- the scanner's expiry pass deletes the same objects in both packages,
  each on its own copy of the same drives, flat and versioned buckets;
- ``ilm.tier``: ``TierRegistry`` persists the same bytes, each package
  reads what the other wrote; the sweep journal and ``retry_journal``
  act alike against a recording warm client;
- a transition to a warm tier served by the JAX package's own S3 server
  (started inside the test): the port's scanner uploads the data through
  the port's ``S3Client``, stubs the object, and the bytes read back
  through the port's client and restore.

Every comparison is exact.
"""

import dataclasses
import json
import os
import shutil

os.environ.setdefault("MINIO_TPU_BACKEND", "numpy")
os.environ.setdefault("MINIO_TPU_SCAN_INTERVAL", "0")

import numpy as np
import pytest
from hypothesis import given, seed, settings
from hypothesis import strategies as st

from minio_tpu.erasure.background import BackgroundOps as RefBackground
from minio_tpu.erasure.set import ErasureSet as RefSet
from minio_tpu.ilm import lifecycle as ref_lc
from minio_tpu.ilm import tier as ref_tier
from minio_tpu.server.buckets import BucketMetadataSys as RefBucketMeta
from minio_tpu.storage.xlstorage import XLStorage as RefStorage
from minio_tpu_torch.erasure.background import BackgroundOps
from minio_tpu_torch.erasure.set import TAGS_META_KEY, ErasureSet
from minio_tpu_torch.ilm import lifecycle as lc
from minio_tpu_torch.ilm import tier
from minio_tpu_torch.server.buckets import BucketMetadataSys
from minio_tpu_torch.storage.xlstorage import XLStorage

NOW = 1_790_000_000.0  # a fixed clock for every evaluation
DAY = 24 * 3600


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MINIO_TPU_CACHE", "0")
    monkeypatch.setenv("MINIO_TPU_BACKEND", "numpy")
    monkeypatch.setenv("MINIO_COMPRESSION_ENABLE", "off")


# -- generated lifecycle configurations ------------------------------------

_words = st.sampled_from(["", "a", "a/", "a/b", "logs/", "tmp", "x/y/"])
_tags = st.dictionaries(st.sampled_from(["class", "team", "t"]),
                        st.sampled_from(["", "hot", "cold", "a"]), max_size=2)
_days = st.integers(0, 400)
_dates = st.sampled_from(["2020-01-01T00:00:00Z", "2026-09-01T00:00:00Z",
                          "2026-10-16T12:00:00+00:00", "2031-01-01T00:00:00Z"])


@st.composite
def _rule(draw) -> str:
    out = ["<Rule>"]
    if draw(st.booleans()):
        out.append(f"<ID>{draw(st.sampled_from(['r1', 'expire', 'tier-it']))}</ID>")
    out.append(f"<Status>{draw(st.sampled_from(['Enabled', 'Disabled']))}</Status>")
    prefix, tags = draw(_words), draw(_tags)
    form = draw(st.sampled_from(["legacy", "filter", "and", "none"]))
    if form == "legacy":
        out.append(f"<Prefix>{prefix}</Prefix>")
    elif form == "filter":
        out.append(f"<Filter><Prefix>{prefix}</Prefix></Filter>")
    elif form == "and":
        tag_xml = "".join(f"<Tag><Key>{k}</Key><Value>{v}</Value></Tag>" for k, v in tags.items())
        out.append(f"<Filter><And><Prefix>{prefix}</Prefix>{tag_xml}</And></Filter>")
    if draw(st.booleans()):
        which = draw(st.sampled_from(["days", "date", "marker"]))
        if which == "days":
            out.append(f"<Expiration><Days>{draw(_days)}</Days></Expiration>")
        elif which == "date":
            out.append(f"<Expiration><Date>{draw(_dates)}</Date></Expiration>")
        else:
            val = draw(st.sampled_from(["true", "false", "TRUE"]))
            out.append(f"<Expiration><ExpiredObjectDeleteMarker>{val}"
                       "</ExpiredObjectDeleteMarker></Expiration>")
    if draw(st.booleans()):
        newer = draw(st.integers(0, 3))
        keep = f"<NewerNoncurrentVersions>{newer}</NewerNoncurrentVersions>" if newer else ""
        out.append(f"<NoncurrentVersionExpiration><NoncurrentDays>{draw(_days)}</NoncurrentDays>"
                   f"{keep}</NoncurrentVersionExpiration>")
    if draw(st.booleans()):
        when = (f"<Days>{draw(_days)}</Days>" if draw(st.booleans())
                else f"<Date>{draw(_dates)}</Date>")
        tier_xml = (f"<StorageClass>{draw(st.sampled_from(['WARM', 'GLACIER']))}</StorageClass>"
                    if draw(st.booleans()) else "")
        out.append(f"<Transition>{when}{tier_xml}</Transition>")
    out.append("</Rule>")
    return "".join(out)


_configs = st.lists(_rule(), min_size=0, max_size=4).map(
    lambda rules: "<LifecycleConfiguration>" + "".join(rules) + "</LifecycleConfiguration>")


@st.composite
def _state(draw) -> dict:
    latest = draw(st.booleans())
    return {
        "key": draw(st.sampled_from(["a", "a/b/c", "logs/2026/x", "tmp1", "x/y/z", "zz"])),
        "mod_time_ns": int((NOW - draw(st.integers(0, 500)) * DAY
                            - draw(st.integers(0, DAY))) * 1e9),
        "is_latest": latest,
        "delete_marker": draw(st.booleans()),
        "num_versions": draw(st.integers(1, 4)),
        "successor_mod_time_ns": 0 if latest else int((NOW - draw(st.integers(0, 500)) * DAY)
                                                      * 1e9),
        "noncurrent_rank": 0 if latest else draw(st.integers(1, 4)),
        "tags": draw(_tags),
    }


def _validates(mod, xml) -> str:
    try:
        mod.validate_lifecycle(xml)
        return "ok"
    except ValueError as e:
        return f"ValueError: {e}"


@seed(20261016)
@settings(max_examples=300, deadline=None, database=None)
@given(_configs, st.lists(_state(), min_size=1, max_size=6))
def test_lifecycle_agrees_on_generated_rules(xml, states):
    ours, theirs = lc.parse_lifecycle(xml), ref_lc.parse_lifecycle(xml)
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in theirs]
    assert _validates(lc, xml) == _validates(ref_lc, xml)
    for s in states:
        a, b = lc.ObjectState(**s), ref_lc.ObjectState(**s)
        act = lc.eval_action(ours, a, now=NOW)
        assert act == ref_lc.eval_action(theirs, b, now=NOW)
        assert lc.transition_tier_for(ours, a, now=NOW) == \
            ref_lc.transition_tier_for(theirs, b, now=NOW)


def test_lifecycle_constants_match():
    for name in ("DAY", "ACTION_NONE", "ACTION_DELETE", "ACTION_DELETE_VERSION",
                 "ACTION_DELETE_MARKER", "ACTION_TRANSITION"):
        assert getattr(lc, name) == getattr(ref_lc, name)
    assert lc.parse_lifecycle("") == [] == ref_lc.parse_lifecycle("")


# -- the scanner's expiry pass ----------------------------------------------

EXPIRY = (
    "<LifecycleConfiguration>"
    "<Rule><ID>old</ID><Status>Enabled</Status><Filter><Prefix>old/</Prefix></Filter>"
    "<Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>"
    "<Rule><ID>tmp</ID><Status>Enabled</Status><Filter><And><Prefix></Prefix>"
    "<Tag><Key>class</Key><Value>tmp</Value></Tag></And></Filter>"
    "<Expiration><Date>2021-06-01T00:00:00Z</Date></Expiration></Rule>"
    "<Rule><ID>off</ID><Status>Disabled</Status><Filter><Prefix>keep/</Prefix></Filter>"
    "<Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>"
    "<Rule><ID>later</ID><Status>Enabled</Status><Filter><Prefix>new/</Prefix></Filter>"
    "<Expiration><Days>3650</Days></Expiration></Rule>"
    "</LifecycleConfiguration>"
)
KEYS = {  # key -> tags
    "old/a": "", "old/b/c": "class=keep", "keep/a": "", "keep/b": "class=tmp",
    "new/a": "", "new/b": "class=tmp&team=x", "other": "", "old": "",
}


def _drives(root):
    return [os.path.join(str(root), f"d{i}") for i in range(4)]


def _versions(store, bucket):
    out = {}
    for raw in sorted(store.walk_objects(bucket)):
        out[raw] = [(v.is_latest, v.delete_marker, v.size, v.etag)
                    for v in store.list_object_versions(bucket, raw)]
    return out


def test_scanner_expiry_deletes_the_same_objects(tmp_path):
    ref = RefSet([RefStorage(p) for p in _drives(tmp_path / "a")])
    bms = RefBucketMeta(ref)
    for b, versioned in (("ilm-flat", False), ("ilm-ver", True)):
        ref.make_bucket(b)
        bm = bms.get(b)
        bm.lifecycle, bm.versioning = EXPIRY, versioned
        bms.set(b, bm)
        for i, (k, tags) in enumerate(KEYS.items()):
            body = np.random.default_rng(i).integers(0, 256, 1000 + 37 * i, np.uint8).tobytes()
            ref.put_object(b, k, body, user_defined={TAGS_META_KEY: tags} if tags else None,
                           versioned=versioned)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    port = ErasureSet([XLStorage(p) for p in _drives(tmp_path / "b")])
    ref_bg = RefBackground(ref, scan_interval=0, object_sleep=0, bucket_meta=bms)
    bg = BackgroundOps(port, scan_interval=0, object_sleep=0,
                       bucket_meta=BucketMetadataSys(port))
    want, got = ref_bg.scan_once().snapshot(), bg.scan_once().snapshot()
    for k in ("bucketsCount", "objectsCount", "objectsTotalSize", "cycles", "bucketsUsage"):
        assert got[k] == want[k], k
    assert bg.stats == ref_bg.stats
    # old/a, old/b/c (prefix), keep/b and new/b (tag) in each bucket
    assert bg.stats["ilm_expired"] == 8
    for b in ("ilm-flat", "ilm-ver"):
        assert _versions(port, b) == _versions(ref, b)
    flat = _versions(port, "ilm-flat")
    assert sorted(flat) == ["keep/a", "new/a", "old", "other"]
    ver = _versions(port, "ilm-ver")
    assert [v[1] for v in ver["old/a"]] == [True, False]  # a delete marker on top


# -- tiers: the registry, the sweep journal ---------------------------------


def _read(store, bucket, key) -> bytes:
    _, it = store.get_object(bucket, key)
    return b"".join(bytes(c) for c in it)


def _tier_fields(mod):
    return mod.Tier(name="WARM", endpoint="http://127.0.0.1:1", access_key="ak",
                    secret_key="sk", bucket="tier-data", prefix="p/", tier_type="minio")


def test_tier_registry_persists_the_same_bytes(tmp_path):
    ref = RefSet([RefStorage(p) for p in _drives(tmp_path / "a")])
    port = ErasureSet([XLStorage(p) for p in _drives(tmp_path / "b")])
    for mod, store in ((ref_tier, ref), (tier, port)):
        reg = mod.TierRegistry(store)
        reg.set(_tier_fields(mod))
        reg.set(mod.Tier(name="COLD", endpoint="e", access_key="a", secret_key="s",
                         bucket="b", tier_type="azure"))
        reg.remove("COLD")
        reg.get("WARM").client()  # the cached client is never persisted
        reg.set(reg.get("WARM"))
    doc = _read(port, tier.SYSTEM_BUCKET, tier.TIERS_KEY)
    assert doc == _read(ref, ref_tier.SYSTEM_BUCKET, ref_tier.TIERS_KEY)
    assert json.loads(doc) == {"WARM": dataclasses.asdict(_tier_fields(tier))}
    # each package reads what the other wrote
    assert tier.TierRegistry(ref).get("WARM").to_dict() == \
        ref_tier.TierRegistry(port).get("WARM").to_dict()
    for name in ("SYSTEM_BUCKET", "TIERS_KEY", "JOURNAL_KEY", "TRANSITION_TIER_META",
                 "TRANSITION_KEY_META", "RESTORE_EXPIRY_META"):
        assert getattr(tier, name) == getattr(ref_tier, name)


def test_erasure_set_takes_its_ilm_keys_from_the_tier_module():
    """The port's ILM metadata keys have one definition, ``ilm/tier.py``;
    the object layer imports them from there, as the reference does."""
    import inspect

    from minio_tpu_torch.erasure import set as setmod

    assert tier.TRANSITION_TIER_META == "x-minio-internal-transition-tier"
    assert tier.TRANSITION_KEY_META == "x-minio-internal-transitioned-key"
    assert tier.RESTORE_EXPIRY_META == "x-minio-internal-restore-expiry"
    src = inspect.getsource(setmod)
    for name in ("TRANSITION_TIER_META", "TRANSITION_KEY_META", "RESTORE_EXPIRY_META"):
        assert not hasattr(setmod, name), name
        assert f'{name} = "' not in src
    assert src.count("from ..ilm.tier import") == 2


class _Warm:
    """A warm client that records deletes and answers from a script."""

    def __init__(self, statuses):
        self.statuses, self.calls = list(statuses), []

    def delete_object(self, bucket, key):
        self.calls.append((bucket, key))
        st_ = self.statuses.pop(0)
        if st_ is None:
            raise OSError("tier endpoint down")
        return type("R", (), {"status": st_})()


def test_journal_and_retry_behave_alike(tmp_path):
    stores = {"ref": RefSet([RefStorage(p) for p in _drives(tmp_path / "a")]),
              "port": ErasureSet([XLStorage(p) for p in _drives(tmp_path / "b")])}
    seen = {}
    for name, mod in (("ref", ref_tier), ("port", tier)):
        store = stores[name]
        reg = mod.TierRegistry(store)
        reg.set(_tier_fields(mod))
        warm = _Warm([None, 500, 204, 404, None, 204])
        reg.get("WARM")._client = warm
        ud = {mod.TRANSITION_TIER_META: "WARM", mod.TRANSITION_KEY_META: "p/b/k/1"}
        mod.sweep_remote(reg, ud)  # endpoint down: journaled
        mod.sweep_remote(reg, {**ud, mod.TRANSITION_KEY_META: "p/b/k/2"})  # 500: journaled
        mod.sweep_remote(reg, {})  # not transitioned: nothing
        mod.journal_add(store, "GONE", "p/b/k/3")  # its tier is not configured
        first = _read(store, mod.SYSTEM_BUCKET, mod.JOURNAL_KEY)
        left = [mod.retry_journal(reg)]  # 204, 404 resolve; GONE drops
        mod.journal_add(store, "WARM", "p/b/k/4")
        left.append(mod.retry_journal(reg))  # endpoint down: stays
        left.append(mod.retry_journal(reg))  # 204: resolved
        seen[name] = (first, _read(store, mod.SYSTEM_BUCKET, mod.JOURNAL_KEY), left, warm.calls,
                      mod.journal_size(store))
    assert seen["port"] == seen["ref"]
    assert seen["port"][2] == [0, 1, 0]


# -- a transition to a warm tier served by the JAX package's S3 server -------

TRANSITION_NOW = (
    "<LifecycleConfiguration><Rule><ID>t0</ID><Status>Enabled</Status>"
    "<Filter><Prefix>cold/</Prefix></Filter>"
    "<Transition><Days>0</Days><StorageClass>WARM</StorageClass></Transition>"
    "</Rule></LifecycleConfiguration>"
)


@pytest.fixture(scope="module")
def warm_server(tmp_path_factory):
    from minio_tpu.client import S3Client as RefClient
    from tests.test_s3_api import ServerThread

    prev = os.environ.get("MINIO_COMPRESSION_ENABLE")
    os.environ["MINIO_COMPRESSION_ENABLE"] = "off"
    base = tmp_path_factory.mktemp("warm")
    srv = ServerThread([str(base / f"w{i}") for i in range(4)])
    assert RefClient(f"127.0.0.1:{srv.port}").make_bucket("tier-data").status == 200
    yield srv
    srv.stop()
    if prev is None:
        os.environ.pop("MINIO_COMPRESSION_ENABLE", None)
    else:
        os.environ["MINIO_COMPRESSION_ENABLE"] = prev


def _parts(drives, bucket, key):
    return sorted(os.path.relpath(os.path.join(dp, f), d) for d in drives
                  for dp, _, fs in os.walk(os.path.join(d, bucket, key))
                  for f in fs if f.startswith("part."))


def test_transition_to_a_warm_tier_reads_back_through_the_port(tmp_path, warm_server):
    from minio_tpu_torch.client import S3Client

    body = np.random.default_rng(7).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    ref = RefSet([RefStorage(p) for p in _drives(tmp_path / "a")])
    ref.make_bucket("ilmbkt")
    ref.put_object("ilmbkt", "cold/data.bin", body)
    ref.put_object("ilmbkt", "hot/data.bin", body[:5000])
    bm = RefBucketMeta(ref).get("ilmbkt")
    bm.lifecycle = TRANSITION_NOW
    RefBucketMeta(ref).set("ilmbkt", bm)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    port = ErasureSet([XLStorage(p) for p in _drives(tmp_path / "b")])
    endpoint = f"http://127.0.0.1:{warm_server.port}"
    infos = {}
    for name, mod, store, bg_cls, meta_cls in (
            ("ref", ref_tier, ref, RefBackground, RefBucketMeta),
            ("port", tier, port, BackgroundOps, BucketMetadataSys)):
        reg = mod.TierRegistry(store)
        reg.set(mod.Tier(name="WARM", endpoint=endpoint, access_key="minioadmin",
                         secret_key="minioadmin", bucket="tier-data", prefix=f"{name}/"))
        bg = bg_cls(store, scan_interval=0, object_sleep=0, bucket_meta=meta_cls(store),
                    tiers=reg)
        bg.scan_once()
        assert bg.stats["ilm_transitioned"] == 1
        infos[name] = store.get_object_info("ilmbkt", "cold/data.bin")
    oi = infos["port"]
    assert (oi.size, oi.etag) == (infos["ref"].size, infos["ref"].etag) == (len(body), oi.etag)
    assert oi.user_defined[tier.TRANSITION_TIER_META] == "WARM"
    rkey = oi.user_defined[tier.TRANSITION_KEY_META]
    assert rkey.startswith("port/ilmbkt/cold/data.bin/")
    # the local shards are gone in both; the object outside the rule stays
    for root in ("a", "b"):
        assert _parts(_drives(tmp_path / root), "ilmbkt", "cold/data.bin") == []
    assert _read(port, "ilmbkt", "hot/data.bin") == body[:5000]
    assert tier.TRANSITION_TIER_META not in port.get_object_info(
        "ilmbkt", "hot/data.bin").user_defined
    # the bytes live on the warm tier: read back through the port's client
    cli = S3Client(endpoint)
    got = cli.get_object("tier-data", rkey)
    assert got.status == 200 and got.body == body
    ref_key = infos["ref"].user_defined[ref_tier.TRANSITION_KEY_META]
    assert cli.get_object("tier-data", ref_key).body == body
    # and restored into the port's store from there
    port.restore_object("ilmbkt", "cold/data.bin", got.body, days=1)
    assert _read(port, "ilmbkt", "cold/data.bin") == body
    assert port.get_object_info("ilmbkt", "cold/data.bin").user_defined.get(
        tier.RESTORE_EXPIRY_META)
