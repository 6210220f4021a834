"""The port's ProgramDesc wire format (static/proto_io.py, its own copy
of the JAX package's jax-free codec) against the JAX package's, on the
CPU: the cases of tests/test_proto_io.py on both packages, and the
bytes of each of their programs identical across the packages.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu.static.proto_io as jproto
import paddle_tpu_torch.static.proto_io as tproto
from torch_static_twins import assert_close, run_both


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_program(P):
    static = P.static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [4, 3], "float32")
        y = static.data("y", [4, 1], "float32")
        out = static.nn.fc(x, 1)
        loss = ((out - y) ** 2).mean()
        P.p.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _proto(P):
    return tproto if P.port else jproto


def _bytes(P):
    main, _, _ = _tiny_program(P)
    pr = _proto(P)
    b1, b2 = pr.serialize_program_desc(main), pr.serialize_program_desc(main)
    assert b1 == b2
    return b1


def test_bytes_identical_across_packages():
    j, t = run_both(_bytes)
    assert j == t
    assert t[0] == 0x0A and t.endswith(b"\x22\x02\x08\x00")
    assert t.index(b"\x08\x00\x10") > 0


def _round_trip(P):
    main, _, _ = _tiny_program(P)
    desc = _proto(P).parse_program_desc(_proto(P).serialize_program_desc(
        main))
    blk = desc["blocks"][0]
    live = {v.name: v for v in main.global_block.vars.values()}
    got = {v["name"]: v for v in blk["vars"]}
    assert set(got) == set(live)
    for name, v in live.items():
        assert got[name]["shape"] == [int(d) for d in v.shape], name
        assert got[name]["persistable"] == bool(v.persistable), name
    assert [o["type"] for o in blk["ops"]] == [od.op_type for od in main.ops]
    assert [o["kind"] for o in blk["ops"]] == [od.kind for od in main.ops]
    for o, od in zip(blk["ops"], main.ops):
        assert o["inputs"] == list(od.input_names)
        assert o["outputs"] == list(od.output_names)
    return desc


def test_wire_round_trip_preserves_structure():
    j, t = run_both(_round_trip)
    assert j == t


def _ref_names(P):
    main, _, _ = _tiny_program(P)
    pr = _proto(P)
    desc = pr.parse_program_desc(pr.serialize_program_desc(main))
    for o in desc["blocks"][0]["ops"]:
        if o["type"] in pr.LOCAL_TO_REF_OP:
            assert o["ref_type"] == pr.LOCAL_TO_REF_OP[o["type"]]
        assert o["type"] != ""
    return [(o["type"], o["ref_type"]) for o in desc["blocks"][0]["ops"]]


def test_ref_op_names_on_the_wire():
    j, t = run_both(_ref_names)
    assert j == t


def test_checked_in_schema_file_in_sync():
    """framework_compat.proto beside the port's codec is its COMPAT_PROTO,
    and both equal the JAX package's (the same wire contract)."""
    path = os.path.join(os.path.dirname(tproto.__file__),
                        "framework_compat.proto")
    assert open(path).read() == tproto.COMPAT_PROTO == jproto.COMPAT_PROTO
    assert tproto.REF_TO_LOCAL_OP == jproto.REF_TO_LOCAL_OP
    assert tproto.LOCAL_TO_REF_OP == jproto.LOCAL_TO_REF_OP


def _retrain(P, tmp):
    static = P.static
    io = __import__(f"{P.p.__name__}.static.io", fromlist=["io"])
    main, startup, loss = _tiny_program(P)
    exe = P.exe()
    P.startup(exe, startup)
    rs = np.random.RandomState(0)
    xv = rs.randn(4, 3).astype(np.float32)
    yv = rs.randn(4, 1).astype(np.float32)
    for _ in range(3):
        exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss])
    path = os.path.join(tmp, "port" if P.port else "jax", "model")
    io.save_program(main, path, format="proto")
    raw = open(path + ".pdmodel", "rb").read()
    assert raw[:1] == b"\x0a"
    expected = exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss])[0]
    static.global_scope().drop_kids()
    P.p.utils.unique_name.switch()
    main2, _, loss2 = _tiny_program(P)
    io.load_program(main2, path)
    resumed = exe.run(main2, feed={"x": xv, "y": yv},
                      fetch_list=[loss2])[0]
    np.testing.assert_allclose(resumed, expected, rtol=1e-6)
    main3, startup3 = static.Program(), static.Program()
    with static.program_guard(main3, startup3):
        static.nn.fc(static.data("x", [4, 3], "float32"), 2)
    with pytest.raises(ValueError):
        io.load_program(main3, path)
    return expected, resumed, raw


def test_save_load_retrain_parity_proto_format(tmp_path):
    j, t = run_both(_retrain, str(tmp_path))
    assert_close(j[:2], t[:2])
    assert j[2] == t[2]


def test_cross_package_parse():
    """Each package's parser reads the other's bytes to the same
    structure."""
    j, t = run_both(_bytes)
    assert jproto.parse_program_desc(t) == tproto.parse_program_desc(j)


def test_packed_repeated_dims_parse():
    def varint(n):
        n &= (1 << 64) - 1
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    payload = b"".join(varint(d) for d in (-1, 640, 480))
    msg = b"\x08\x05" + b"\x12" + varint(len(payload)) + payload
    for pr in (jproto, tproto):
        assert pr._parse_tensor_desc(msg) == ("float32", [-1, 640, 480])
