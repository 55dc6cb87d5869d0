"""The port's SFTP gateway (minio_tpu_torch/server/sftp.py on its
server/ssh.py transport) against the JAX package's.

* The JAX package's SFTP cases (tests/test_sftp.py), each run unchanged
  with the reference's client against the port's gateway and server.
* A differential run: one seeded sequence of SFTP and FTP operations
  against each package's gateways gives the same status and reply codes,
  listings (names and sizes) and bytes, empty and odd-sized files included.
* Interop on shared drives: what one package's gateway writes, the other
  package's other gateway reads back byte for byte.
* Writes take the STANDARD storage class, as an S3 PUT does.

The port runs on its stdlib HTTP front with ``MINIO_TPU_BACKEND=torch``
on the CPU.
"""

from __future__ import annotations

import ftplib
import inspect
import io
import stat as stat_mod

import numpy as np
import pytest

pytest.importorskip("cryptography")

import chip_smoke  # noqa: E402  (the port's SFTP client)
import tests.test_sftp as ref_cases  # noqa: E402
from tests.test_torch_ftp import serve_ftp  # noqa: E402
from tests.test_torch_s3_api import PORT_ENV, PortServerThread  # noqa: E402

SEED = 20261017
# in the file's order: later cases use the bucket the third one makes
REF_CASES = [n for n, f in vars(ref_cases).items()
             if n.startswith("test_") and inspect.isfunction(f)]


@pytest.fixture(scope="module")
def port_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PORT_ENV.items():
            mp.setenv(k, v)
        yield mp


# -- the reference's cases on the port -----------------------------------------


@pytest.fixture(scope="module")
def server(port_env, tmp_path_factory):
    base = tmp_path_factory.mktemp("port-sftp-drives")
    st = PortServerThread([str(base / f"d{i}") for i in range(4)])
    st.drive0 = str(base / "d0")
    yield st
    st.stop()


@pytest.fixture(scope="module")
def gateway(server):
    from minio_tpu_torch.server import sftp

    gw = sftp.SFTPGateway(server.srv)
    port = gw.listen("127.0.0.1", 0)
    yield gw, port
    gw.close()


@pytest.fixture(scope="module")
def s3(server):
    from minio_tpu_torch.client import S3Client

    return S3Client(f"127.0.0.1:{server.port}")


@pytest.fixture()
def cli(gateway):
    c = ref_cases.SFTPClient(gateway[1], "minioadmin", "minioadmin")
    yield c
    c.close()


def test_reference_cases_are_all_here():
    assert len(REF_CASES) == 10


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_case_on_the_port(case, monkeypatch, request):
    from minio_tpu_torch.server import sftp

    # the case that builds a gateway of its own builds the port's
    monkeypatch.setattr(ref_cases, "sftpmod", sftp)
    fn = getattr(ref_cases, case)
    fn(**{p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters})


@pytest.mark.parametrize("spec,want", [("EC:1", (3, 1)), ("", (2, 2))])
def test_writes_take_the_standard_storage_class(gateway, s3, server, monkeypatch, spec, want):
    """An SFTP write, rename and mkdir land at the parity an S3 PUT gets
    (MinIO's object layer applies MINIO_STORAGE_CLASS_STANDARD to every
    frontend; the reference's gateway wrote at the set's default parity,
    ROADMAP Queue 3)."""
    from minio_tpu_torch.erasure.listing import encode_dir_object
    from minio_tpu_torch.storage.xlstorage import XLStorage

    monkeypatch.setenv("MINIO_STORAGE_CLASS_STANDARD", spec)
    assert s3.make_bucket("sftp-class").status in (200, 409)
    tag = spec.replace(":", "") or "default"
    c = chip_smoke.SFTPClient(gateway[1], "minioadmin", "minioadmin")
    try:
        c.put(f"/sftp-class/put-{tag}.bin", b"std" * 999)
        c.put(f"/sftp-class/old-{tag}.bin", b"old" * 99)
        fx = c.fx
        assert c.status(fx.FXP_RENAME, c.ssh.wstr(f"/sftp-class/old-{tag}.bin")
                        + c.ssh.wstr(f"/sftp-class/new-{tag}.bin")) == fx.FX_OK
        assert c.status(fx.FXP_MKDIR, c.ssh.wstr(f"/sftp-class/dir-{tag}")
                        + c.ssh.wu32(0)) == fx.FX_OK
    finally:
        c.close()
    assert s3.put_object("sftp-class", f"s3-{tag}.bin", b"std" * 999).status == 200
    for k in (f"put-{tag}.bin", f"new-{tag}.bin", f"s3-{tag}.bin",
              encode_dir_object(f"dir-{tag}/")):
        e = XLStorage(server.drive0).read_version("sftp-class", k, "").erasure
        assert (e.data_blocks, e.parity_blocks) == want, k


# -- the differential run -------------------------------------------------------


def _body(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


# sizes across the SFTP packet (32 KiB) and the stripe block (1 MiB)
SIZES = [0, 1, 31, 32_768, 32_769, 100_003, (1 << 20) + 17]


def _sftp_transcript(port: int) -> list:
    """One seeded sequence of SFTP operations: what each answered."""
    c = chip_smoke.SFTPClient(port, "minioadmin", "minioadmin")
    fx, w = c.fx, c.ssh.wstr
    out: list = []

    def stat(path):
        try:
            size, perms = c.stat(path)
            return "attrs", size, stat_mod.S_IFMT(perms)
        except chip_smoke.SFTPError as e:
            return "status", e.code

    try:
        out.append(("realpath", [c.realpath(p) for p in (".", "/", "a/../b", "/x/./y/")]))
        out.append(("mkdir", c.status(fx.FXP_MKDIR, w("/diffbkt") + c.ssh.wu32(0))))
        out.append(("mkdir again", c.status(fx.FXP_MKDIR, w("/diffbkt") + c.ssh.wu32(0))))
        for i, n in enumerate(SIZES):
            key = f"/diffbkt/{'deep/' if i % 2 else ''}f{i}.bin"
            c.put(key, _body(n, SEED + i))
            out.append(("put", key, stat(key)))
        out.append(("mkdir key", c.status(fx.FXP_MKDIR, w("/diffbkt/sub/dir") + c.ssh.wu32(0))))
        for path in ("/", "/diffbkt", "/diffbkt/deep", "/diffbkt/sub", "/diffbkt/nope"):
            try:
                out.append(("ls", path, sorted(c.listdir(path))))
            except chip_smoke.SFTPError as e:
                out.append(("ls", path, e.code))
        for i in range(len(SIZES)):
            key = f"/diffbkt/{'deep/' if i % 2 else ''}f{i}.bin"
            out.append(("get", key, c.get(key) == _body(SIZES[i], SEED + i)))
        out.append(("stat", [stat(p) for p in ("/", "/diffbkt", "/diffbkt/deep",
                                                "/diffbkt/nope.bin", "/nobucket")]))
        out.append(("rename", c.status(fx.FXP_RENAME, w("/diffbkt/f2.bin") + w("/diffbkt/g2.bin")),
                    stat("/diffbkt/f2.bin"), stat("/diffbkt/g2.bin")))
        out.append(("rename bucket", c.status(fx.FXP_RENAME, w("/diffbkt") + w("/other"))))
        out.append(("remove", c.status(fx.FXP_REMOVE, w("/diffbkt/g2.bin")),
                    c.status(fx.FXP_REMOVE, w("/diffbkt/g2.bin")),
                    c.status(fx.FXP_REMOVE, w("/diffbkt"))))
        out.append(("rmdir key", c.status(fx.FXP_RMDIR, w("/diffbkt/sub/dir"))))
        out.append(("open missing", c.request(fx.FXP_OPEN, w("/diffbkt/none") + c.ssh.wu32(
            fx.PF_READ) + c.ssh.wu32(0))[0]))
        out.append(("unsupported", c.request(200, b"")[0]))
        out.append(("ls after", sorted(c.listdir("/diffbkt"))))
    finally:
        c.close()
    return out


def _ftp_transcript(port: int) -> list:
    """One seeded sequence of FTP commands: each reply's code, listings
    and bytes."""
    f = ftplib.FTP()
    f.connect("127.0.0.1", port, timeout=60)
    out: list = [("welcome", f.getwelcome()[:3])]

    def cmd(line):
        try:
            return f.sendcmd(line)[:3]
        except ftplib.Error as e:
            return str(e)[:3]

    try:
        out.append(("bad login", cmd("USER minioadmin"), cmd("PASS wrong")))
        out.append(("list before login", cmd("PWD")))
        f.login("minioadmin", "minioadmin")
        out.append(("syst", cmd("SYST"), cmd("TYPE I"), cmd("NOOP"), cmd("PWD")))
        out.append(("mkd", cmd("MKD /ftpdiff"), cmd("MKD /ftpdiff/folder")))
        for i, n in enumerate(SIZES):
            f.storbinary(f"STOR /ftpdiff/{'folder/' if i % 2 else ''}o{i}.bin",
                         io.BytesIO(_body(n, SEED + 100 + i)))
            out.append(("size", i, cmd(f"SIZE /ftpdiff/{'folder/' if i % 2 else ''}o{i}.bin")))
        for path in ("/", "/ftpdiff", "/ftpdiff/folder"):
            lines: list = []
            f.retrlines(f"LIST {path}", lines.append)
            out.append(("list", path, sorted(lines), sorted(f.nlst(path))))
        out.append(("cwd", cmd("CWD /ftpdiff"), cmd("PWD"), cmd("CWD /nope"), cmd("CDUP"),
                    cmd("PWD")))
        for i, n in enumerate(SIZES):
            buf = io.BytesIO()
            f.retrbinary(f"RETR /ftpdiff/{'folder/' if i % 2 else ''}o{i}.bin", buf.write)
            out.append(("retr", i, buf.getvalue() == _body(n, SEED + 100 + i)))
        try:
            f.retrbinary("RETR /ftpdiff/missing.bin", lambda b: None)
            out.append(("retr missing", "ok"))
        except ftplib.Error as e:
            out.append(("retr missing", str(e)[:3]))
        out.append(("dele", cmd("DELE /ftpdiff/o0.bin"), cmd("SIZE /ftpdiff/o0.bin")))
        out.append(("rmd", cmd("RMD /ftpdiff/folder"), cmd("RMD /ftpdiff")))
        out.append(("unknown", cmd("SITE CHMOD 644 x"), cmd("STOR"), cmd("FEAT")))
        out.append(("quit", f.quit()[:3]))
    finally:
        f.close()
    return out


@pytest.fixture(scope="module")
def both(port_env, tmp_path_factory):
    """Each package's server object with its SFTP and FTP gateways, over
    drives of its own: {package: (sftp port, ftp port)}."""
    from minio_tpu.server import ftp as ref_ftp
    from minio_tpu.server import sftp as ref_sftp
    from minio_tpu.server.app import make_server as ref_make
    from minio_tpu_torch.server import ftp as port_ftp
    from minio_tpu_torch.server import sftp as port_sftp
    from minio_tpu_torch.server.app import make_server as port_make

    base = tmp_path_factory.mktemp("sftp-diff")
    srvs = {"ref": ref_make([str(base / "r" / f"d{i}") for i in range(4)]),
            "port": port_make([str(base / "p" / f"d{i}") for i in range(4)])}
    mods = {"ref": (ref_sftp, ref_ftp), "port": (port_sftp, port_ftp)}
    out, stops = {}, []
    for name, srv in srvs.items():
        gw = mods[name][0].SFTPGateway(srv)
        fport, stop = serve_ftp(mods[name][1].FTPGateway, srv)
        stops += [gw.close, stop, srv.close]
        out[name] = (gw.listen("127.0.0.1", 0), fport)
    yield out
    for stop in stops:
        stop()


def test_sftp_sequence_matches_the_reference(both):
    port, ref = _sftp_transcript(both["port"][0]), _sftp_transcript(both["ref"][0])
    assert port == ref
    assert ("get", "/diffbkt/deep/f1.bin", True) in port  # the bytes were checked


def test_ftp_sequence_matches_the_reference(both):
    port, ref = _ftp_transcript(both["port"][1]), _ftp_transcript(both["ref"][1])
    assert port == ref
    assert ("retr", 6, True) in port


# -- interop on shared drives -------------------------------------------------------


@pytest.fixture(scope="module")
def shared(port_env, tmp_path_factory):
    """Both packages' servers over the same four drives (read cache off),
    each with its SFTP and FTP gateways."""
    from minio_tpu.server import ftp as ref_ftp
    from minio_tpu.server import sftp as ref_sftp
    from minio_tpu_torch.server import ftp as port_ftp
    from minio_tpu_torch.server import sftp as port_sftp
    from tests.test_s3_api import ServerThread

    base = tmp_path_factory.mktemp("sftp-shared")
    drives = [str(base / f"d{i}") for i in range(4)]
    threads = {"ref": ServerThread(drives)}  # mints format.json
    threads["port"] = PortServerThread(drives)
    mods = {"ref": (ref_sftp, ref_ftp), "port": (port_sftp, port_ftp)}
    out, stops = {}, []
    for name, st in threads.items():
        gw = mods[name][0].SFTPGateway(st.srv)
        fport, stop = serve_ftp(mods[name][1].FTPGateway, st.srv)
        stops += [gw.close, stop, st.stop]
        out[name] = (gw.listen("127.0.0.1", 0), fport)
    c = chip_smoke.SFTPClient(out["ref"][0], "minioadmin", "minioadmin")
    assert c.status(c.fx.FXP_MKDIR, c.ssh.wstr("/shared") + c.ssh.wu32(0)) == c.fx.FX_OK
    c.close()
    yield out
    for stop in stops:
        stop()


@pytest.mark.parametrize("size", [0, 100_003, (1 << 20) + 5])
@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_sftp_write_reads_back_through_the_other_packages_ftp(shared, writer, reader, size):
    body = _body(size, SEED + size)
    key = f"sftp-{writer}-{size}.bin"
    c = chip_smoke.SFTPClient(shared[writer][0], "minioadmin", "minioadmin")
    try:
        c.put(f"/shared/{key}", body)
    finally:
        c.close()
    f = ftplib.FTP()
    f.connect("127.0.0.1", shared[reader][1], timeout=60)
    f.login("minioadmin", "minioadmin")
    try:
        buf = io.BytesIO()
        f.retrbinary(f"RETR /shared/{key}", buf.write)
        assert f.size(f"/shared/{key}") == size
    finally:
        f.quit()
    assert buf.getvalue() == body


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_ftp_write_reads_back_through_the_other_packages_sftp(shared, writer, reader):
    body = _body(300_001, SEED + 7)
    key = f"ftp-{writer}.bin"
    f = ftplib.FTP()
    f.connect("127.0.0.1", shared[writer][1], timeout=60)
    f.login("minioadmin", "minioadmin")
    try:
        f.storbinary(f"STOR /shared/{key}", io.BytesIO(body))
    finally:
        f.quit()
    c = chip_smoke.SFTPClient(shared[reader][0], "minioadmin", "minioadmin")
    try:
        assert c.stat(f"/shared/{key}")[0] == len(body)
        assert c.get(f"/shared/{key}") == body
        assert (key, len(body), False) in c.listdir("/shared")
    finally:
        c.close()
