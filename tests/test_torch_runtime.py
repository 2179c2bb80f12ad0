"""The port's native runtime (``ppqsflhe_tpu_torch/runtime``): the twin of
``tests/test_native_runtime.py``. The build goes to
``build/ppqsflhe_tpu_torch/runtime/`` (nothing is written inside the
package); the serde codec round-trips at the JAX test's lengths and frames
the port's PQTC blobs; the artifact server answers the comm client's
routes end to end."""

import base64
import os
import shutil
import subprocess
import urllib.request

import numpy as np
import pytest
import torch

from ppqsflhe_tpu_torch.runtime import native
from ppqsflhe_tpu_torch.runtime.native import NativeSerde, build_native, native_server_binary

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


@pytest.fixture(scope="module", autouse=True)
def built():
    assert build_native(), "native build failed"


def test_build_lands_outside_the_package():
    pkg = os.path.dirname(native.__file__)
    assert not os.path.exists(os.path.join(pkg, "bin"))
    assert not os.path.exists(os.path.join(pkg, "lib"))
    assert native_server_binary() == str(native.BUILD_DIR / "bin" / "artifact_server")
    assert (native.BUILD_DIR / "lib" / "libserde.so").exists()


@pytest.mark.parametrize("n", (0, 1, 2, 3, 57, 1000, 65537))
def test_serde_roundtrip(n):
    s = NativeSerde()
    assert s.is_native
    data = os.urandom(n)
    enc = s.encode(data)
    assert enc == base64.b64encode(data).decode()
    assert s.decode(enc) == data


def test_serde_ciphertext_blob():
    """Framing interop with the port's ckks.serialize PQTC blobs."""
    from ppqsflhe_tpu_torch.ckks import serialize as ser
    from ppqsflhe_tpu_torch.ckks.types import Ciphertext

    ct = Ciphertext(torch.arange(2 * 2 * 8, dtype=torch.int64).reshape(2, 2, 8), scale=2.0**40)
    blob = ser.ciphertext_to_bytes(ct)
    s = NativeSerde()
    assert s.decode(s.encode(blob)) == blob
    back = ser.ciphertext_from_bytes(s.decode(s.encode(blob)), device="cpu")
    assert np.array_equal(back.data.numpy(), ct.data.numpy())
    assert back.scale == ct.scale


def test_serde_rejects_malformed_base64():
    with pytest.raises(ValueError, match="malformed"):
        NativeSerde().decode("@@@@")


def test_native_server_end_to_end(tmp_path):
    binary = native_server_binary()
    assert binary
    storage = str(tmp_path / "storage")
    os.makedirs(storage)
    with open(os.path.join(storage, "CC.json"), "w") as f:
        f.write('{"cc": 1}')
    proc = subprocess.Popen([binary, storage, "0"], stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING ")
        base = f"http://127.0.0.1:{int(line.split()[1])}"
        with urllib.request.urlopen(base + "/getCC", timeout=5) as r:
            assert r.read() == b'{"cc": 1}'
        from ppqsflhe_tpu_torch.comm.client import CommClient

        c = CommClient(base, role="client_1")
        payload = str(tmp_path / "w.json")
        with open(payload, "w") as f:
            f.write("WEIGHTS" * 1000)
        c.post_file("/uploadEncWeightsC1", payload, client_id="client_1", type_="w")
        stored = os.path.join(storage, "client_1", "w.json")
        assert open(stored).read() == "WEIGHTS" * 1000
        dest = str(tmp_path / "back.json")
        c.get("/download/client_1/w.json", dest)
        assert open(dest).read() == "WEIGHTS" * 1000
        pk = str(tmp_path / "client_2-public.key")
        with open(pk, "w") as f:
            f.write("PK2")
        c.post_file("/uploadPubKeyC2", pk, client_id="client_2", type_="pubkey")
        with urllib.request.urlopen(base + "/sendPbKeyC2", timeout=5) as r:
            assert r.read() == b"PK2"
    finally:
        proc.terminate()
        proc.wait(timeout=5)
