"""The port's fleet wire codec (``repro_torch/fleet/wire.py``) against
JAX's (``repro/fleet/wire.py``) on the CPU.

* JAX's ``tests/test_wire.py``, case for case, on the port's codec:
  frame round trips over any chunking, transactional rejection of
  malformed frames (truncated, corrupt, oversize, interleaved), the
  payload codecs shared with the signal-shard schema, the config codec
  and endpoints.  Its two hypothesis properties become parametrised
  fixed-seed cases (a hypothesis run writes new ``.hypothesis`` files).
* Frames cross between the frameworks: frames and payloads JAX encodes
  decode in the port, and the port's decode in JAX, to equal arrays and
  dicts: SIGNALS, DRAFT (tide_tiny fp32, the bridge's '/'-joined keys),
  INIT and the json frames.
* The port's departures (ROADMAP, Reference state): bf16 leaves travel
  as their 16-bit words and round-trip with ``torch.equal`` at 2 bytes a
  parameter plus the container; the cap is what the 32-bit length holds
  (a reader may set a lower one), and a payload past it is refused.
* The large-frame path: ``recv_frames`` receives a frame longer than its
  buffer in one piece (a ``memoryview``), keeps a partial frame buffered
  at end of stream, and rejects a corrupt one; ``decode_npz`` returns
  arrays viewing the payload, and reads a compressed .npz too.
"""
import io
import socket
import threading
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as C  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import eagle as jeagle  # noqa: E402
from repro.core.signals import SignalBatch as JaxSignalBatch  # noqa: E402
from repro.fleet import wire as jwire  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import eagle  # noqa: E402
from repro_torch.core.signals import SignalBatch  # noqa: E402
from repro_torch.fleet import wire  # noqa: E402
from repro_torch.fleet.wire import (FRAME_NAMES, FT_BYE, FT_DRAFT, FT_HELLO,  # noqa: E402
                                    FT_SIGNALS, HEADER, MAX_PAYLOAD,
                                    WIRE_VERSION, FrameReader, WireError,
                                    decode_draft, decode_json, decode_npz,
                                    decode_signals, draft_payload,
                                    encode_frame, json_payload,
                                    signals_payload)
from repro_torch.models.config import MLA, FFN_SWIGLU, BlockDef, ModelConfig  # noqa: E402

SEEDS = range(12)      # the fuzz properties' fixed seeds


def _drain(reader, data):
    return list(reader.feed(data))


# ------------------------------------------------------------ round trips
def test_frame_roundtrip_all_types_and_empty_payload():
    reader = FrameReader()
    frames = []
    for ftype in FRAME_NAMES:
        payload = b"" if ftype == FT_BYE else bytes([ftype]) * (7 * ftype)
        frames.append((ftype, payload))
    blob = b"".join(encode_frame(f, p) for f, p in frames)
    out = _drain(reader, blob)
    assert [(f, p) for f, _, p in out] == frames
    assert all(flags == 0 for _, flags, _ in out)
    assert reader.pending_bytes == 0


def test_frame_roundtrip_byte_at_a_time():
    """Feeding one byte at a time yields the same frames, each only on
    its final byte."""
    blob = encode_frame(FT_HELLO, b"x" * 37) + encode_frame(FT_BYE)
    reader = FrameReader()
    out = []
    for i, b in enumerate(blob):
        got = _drain(reader, bytes([b]))
        out.extend(got)
        if got:
            assert i in (len(blob) - 17, len(blob) - 1)
    assert [(f, p) for f, _, p in out] == [(FT_HELLO, b"x" * 37),
                                           (FT_BYE, b"")]


def test_interleaved_frames_one_buffer_split_mid_header():
    a = encode_frame(FT_HELLO, b"one")
    b = encode_frame(FT_SIGNALS, b"two-two")
    c = encode_frame(FT_BYE)
    blob = a + b + c
    cut = len(a) + len(b) + 9           # 9 bytes into c's 16-byte header
    reader = FrameReader()
    out = _drain(reader, blob[:cut])
    assert [(f, p) for f, _, p in out] == [(FT_HELLO, b"one"),
                                           (FT_SIGNALS, b"two-two")]
    assert reader.pending_bytes == 9
    out = _drain(reader, blob[cut:])
    assert [(f, p) for f, _, p in out] == [(FT_BYE, b"")]


def test_truncated_frame_consumes_nothing_and_is_not_an_error():
    reader = FrameReader()
    blob = encode_frame(FT_HELLO, b"payload")
    assert _drain(reader, blob[:-1]) == []
    assert reader.pending_bytes == len(blob) - 1
    out = _drain(reader, blob[-1:])
    assert [(f, p) for f, _, p in out] == [(FT_HELLO, b"payload")]


# --------------------------------------------------------- malformed input
def _header(magic=wire.MAGIC, version=WIRE_VERSION, ftype=FT_HELLO,
            flags=0, length=0, crc=zlib.crc32(b"")):
    return HEADER.pack(magic, version, ftype, flags, length, crc)


CAP = 1024   # a cap below what the header can state, to reach the check


@pytest.mark.parametrize("blob,match", [
    (_header(magic=b"EDIT"), "bad magic"),
    (_header(version=WIRE_VERSION + 1), "unsupported wire version"),
    (_header(ftype=99), "unknown frame type"),
    (_header(flags=0x8000), "reserved flags"),
    (_header(length=CAP + 1), "exceeds MAX_PAYLOAD"),
])
def test_bad_headers_rejected_and_poison(blob, match, monkeypatch):
    monkeypatch.setattr(wire, "MAX_PAYLOAD", CAP)
    reader = FrameReader()
    with pytest.raises(WireError, match=match):
        _drain(reader, blob)
    with pytest.raises(WireError, match="poisoned"):
        _drain(reader, encode_frame(FT_BYE))


def test_crc_mismatch_rejected():
    blob = bytearray(encode_frame(FT_HELLO, b"hello wire"))
    blob[-3] ^= 0xFF
    reader = FrameReader()
    with pytest.raises(WireError, match="CRC"):
        _drain(reader, bytes(blob))
    with pytest.raises(WireError, match="poisoned"):
        _drain(reader, b"")


def test_valid_frames_before_corruption_still_yielded():
    good = encode_frame(FT_HELLO, b"ok")
    reader = FrameReader()
    out = []
    with pytest.raises(WireError, match="bad magic"):
        for frame in reader.feed(good + _header(magic=b"XXXX")):
            out.append(frame)
    assert [(f, p) for f, _, p in out] == [(FT_HELLO, b"ok")]


def test_encode_frame_rejects_bad_type_and_oversize():
    with pytest.raises(WireError, match="unknown frame type"):
        encode_frame(42)

    class _Huge(bytes):
        def __len__(self):
            return MAX_PAYLOAD + 1
    with pytest.raises(WireError, match="exceeds"):
        encode_frame(FT_HELLO, _Huge())


def test_cap_is_what_the_length_field_holds():
    """The port's cap: the largest length the header can state (JAX:
    256 MiB), far above glm4-9b's INIT of ~2.9 GB; JAX's cap still
    refuses such a frame."""
    assert MAX_PAYLOAD == 2 ** 32 - 1
    assert MAX_PAYLOAD > 3 * 10 ** 9 > jwire.MAX_PAYLOAD
    head = _header(length=jwire.MAX_PAYLOAD + 1)
    assert _drain(FrameReader(), head) == []     # waits for the payload
    with pytest.raises(jwire.WireError, match="exceeds"):
        list(jwire.FrameReader().feed(head))


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_roundtrip_any_chunking(seed):
    """Any payload, cut into any chunk size, round-trips (JAX's property
    at fixed seeds: sizes 0-2048, chunks 1-64)."""
    rng = np.random.RandomState(seed)
    size, chunk = rng.randint(0, 2049), rng.randint(1, 65)
    payload = rng.bytes(size)
    blob = encode_frame(FT_SIGNALS, payload)
    reader = FrameReader()
    out = []
    for i in range(0, len(blob), chunk):
        out.extend(_drain(reader, blob[i:i + chunk]))
    assert [(f, p) for f, _, p in out] == [(FT_SIGNALS, payload)]
    assert reader.pending_bytes == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_payload_corruption_never_yields(seed):
    """Flipping any payload byte kills the frame: WireError, no frame
    yielded (JAX's property at fixed seeds: sizes 1-512)."""
    rng = np.random.RandomState(seed)
    size = rng.randint(1, 513)
    payload = rng.bytes(size)
    blob = bytearray(encode_frame(FT_DRAFT, payload))
    blob[HEADER.size + rng.randint(size)] ^= 1 + rng.randint(255)
    reader = FrameReader()
    out = []
    with pytest.raises(WireError):
        for frame in reader.feed(bytes(blob)):
            out.append(frame)
    assert out == []


# ---------------------------------------------------------------- payloads
def test_json_payload_roundtrip_and_rejection():
    obj = {"a": 1, "b": [1, 2], "c": {"d": None}}
    assert decode_json(json_payload(obj)) == obj
    with pytest.raises(WireError, match="bad json"):
        decode_json(b"\xff\xfe not json")
    with pytest.raises(WireError, match="must be an object"):
        decode_json(b"[1, 2]")


def test_npz_payload_rejects_garbage():
    with pytest.raises(WireError, match="bad npz"):
        decode_npz(b"PK\x03\x04 definitely not an npz archive")


def test_signals_payload_matches_shard_schema():
    batches = [
        SignalBatch(np.arange(24, dtype=np.float32).reshape(4, 6),
                    np.arange(4, dtype=np.int32)),
        SignalBatch(np.ones((9, 6), np.float16),
                    np.arange(9, dtype=np.int64)),
    ]
    back, baseline = decode_signals(signals_payload(batches, baseline=0.625))
    assert baseline == 0.625
    assert len(back) == 2
    for orig, got in zip(batches, back):
        np.testing.assert_array_equal(orig.feats, got.feats)
        np.testing.assert_array_equal(orig.tokens, got.tokens)
        assert orig.feats.dtype == got.feats.dtype
        assert orig.tokens.dtype == got.tokens.dtype
    with pytest.raises(WireError, match="not a signal shard"):
        decode_signals(wire.npz_payload({"junk": np.zeros(3)}))


def test_draft_payload_roundtrip_nested_tree():
    dparams = {"fc": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                      "b": np.zeros(3, np.float32)},
               "norm": {"scale": np.ones(3, np.float16)}}
    seq, tree, acc = decode_draft(draft_payload(11, dparams, 0.75))
    assert seq == 11 and acc == 0.75
    assert set(tree) == {"fc", "norm"}
    np.testing.assert_array_equal(tree["fc"]["w"], dparams["fc"]["w"])
    np.testing.assert_array_equal(tree["fc"]["b"], dparams["fc"]["b"])
    assert tree["norm"]["scale"].dtype == np.float16


def test_draft_payload_missing_fields_rejected():
    with pytest.raises(WireError, match="missing"):
        decode_draft(wire.npz_payload(
            {"p/w": np.zeros(2), "__eval_acc__": np.asarray(0.5)}))
    with pytest.raises(WireError, match="no parameters"):
        decode_draft(wire.npz_payload(
            {"__seq__": np.asarray(1), "__eval_acc__": np.asarray(0.5)}))


def test_config_dict_roundtrip():
    cfg = ModelConfig(name="wire", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=97,
                      dtype="float32", chunk_len=8, attn_block_q=32,
                      attn_block_kv=32,
                      pattern=(BlockDef(MLA, FFN_SWIGLU),),
                      capture_layers=(0, 1, 1))
    back = wire.config_from_dict(wire.config_to_dict(cfg))
    assert back == cfg


def test_parse_endpoint():
    assert wire.parse_endpoint("unix:/tmp/x.sock") == ("unix", "/tmp/x.sock")
    assert wire.parse_endpoint("tcp:127.0.0.1:9000") == \
        ("tcp", ("127.0.0.1", 9000))
    for bad in ("unix:", "tcp:nohostport", "http://x", "spawn"):
        with pytest.raises(ValueError):
            wire.parse_endpoint(bad)


# ======================================================= across frameworks
@pytest.fixture(scope="module")
def tiny():
    """tide_tiny's config and JAX's initial draft and embedding (fp32),
    and the same draft bridged into the port."""
    jcfg = C.get("tide-tiny")
    jdcfg = jeagle.draft_config(jcfg)
    jdp = jax.jit(jeagle.draft_init, static_argnums=0)(jdcfg,
                                                       jax.random.key(7))
    cfg = get("tide-tiny")
    dcfg = eagle.draft_config(cfg)
    tdp = bridge.draft_from_numpy(dcfg, jckpt._flatten(jdp), device="cpu")
    embed = np.random.default_rng(0).standard_normal(
        (cfg.vocab_size, cfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, jdcfg=jdcfg, jdp=jdp, cfg=cfg, dcfg=dcfg,
                tdp=tdp, embed=embed)


def _frames_of(blob, reader):
    return list(reader.feed(bytes(blob)))


def _assert_flat_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_config_dicts_equal_jax(tiny):
    """The HELLO's config dicts: the port's tide_tiny and draft configs
    encode to JAX's dicts, and each package decodes the other's."""
    for pc, jc in ((tiny["cfg"], tiny["jcfg"]), (tiny["dcfg"],
                                                 tiny["jdcfg"])):
        assert wire.config_to_dict(pc) == jwire.config_to_dict(jc)
        assert wire.config_from_dict(jwire.config_to_dict(jc)) == pc
        assert jwire.config_from_dict(wire.config_to_dict(pc)) == jc


def test_json_frames_cross(tiny):
    hello = {"tcfg": wire.config_to_dict(tiny["cfg"]),
             "dcfg": wire.config_to_dict(tiny["dcfg"]),
             "train": {"n_threshold": 32, "signal_window": 8,
                       "train_epochs": 1, "train_min_steps": 6, "seed": 0},
             "async": False}
    frames = [(wire.FT_HELLO, hello), (wire.FT_DRAIN, {"token": 3}),
              (wire.FT_DRAIN_ACK, {"token": 3, "cycles": 1, "version": 1,
                                   "failures": 0}),
              (wire.FT_EVENT, {"kind": "train_cycle", "eval_acc": 0.5,
                               "deployed": True, "steps": 6})]
    port_blob = b"".join(encode_frame(f, json_payload(o)) for f, o in frames)
    jax_blob = b"".join(jwire.encode_frame(f, jwire.json_payload(o))
                        for f, o in frames)
    assert port_blob == jax_blob        # json frames are byte-identical
    got = _frames_of(port_blob, jwire.FrameReader())
    assert [(f, jwire.decode_json(p)) for f, _, p in got] == frames
    got = _frames_of(jax_blob, FrameReader())
    assert [(f, decode_json(p)) for f, _, p in got] == frames


def _signal_batches(cls, seed):
    rng = np.random.default_rng(seed)
    return [cls(feats=rng.standard_normal((s, 384)).astype(np.float32),
                tokens=rng.integers(0, 512, s).astype(np.int32))
            for s in (8, 8, 11)]


def test_signals_frames_cross():
    port = signals_payload(_signal_batches(SignalBatch, 1), baseline=0.25)
    back, base = jwire.decode_signals(
        _frames_of(encode_frame(FT_SIGNALS, port),
                   jwire.FrameReader())[0][2])
    jax_side = jwire.signals_payload(_signal_batches(JaxSignalBatch, 1),
                                     baseline=0.25)
    back2, base2 = decode_signals(
        _frames_of(jwire.encode_frame(FT_SIGNALS, jax_side),
                   FrameReader())[0][2])
    want = _signal_batches(SignalBatch, 1)
    assert base == base2 == 0.25
    for got in (back, back2):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.feats.dtype == np.float32 and a.tokens.dtype == np.int32
            np.testing.assert_array_equal(a.feats, b.feats)
            np.testing.assert_array_equal(a.tokens, b.tokens)


def test_draft_frames_cross(tiny):
    """A tide_tiny fp32 draft under the bridge's keys: the port's DRAFT
    decodes in JAX to JAX's draft, JAX's decodes in the port to the
    bridged draft, and the port's tensors equal its own."""
    port = draft_payload(4, tiny["tdp"], 0.5)
    seq, jtree, acc = jwire.decode_draft(
        _frames_of(encode_frame(FT_DRAFT, port), jwire.FrameReader())[0][2])
    assert (seq, acc) == (4, 0.5)
    _assert_flat_equal(jwire.flatten_tree(jtree), jckpt._flatten(tiny["jdp"]))
    jblob = jwire.encode_frame(FT_DRAFT, jwire.draft_payload(
        4, jax.tree.map(np.asarray, tiny["jdp"]), 0.5))
    seq, ptree, acc = decode_draft(_frames_of(jblob, FrameReader())[0][2])
    assert (seq, acc) == (4, 0.5)
    _assert_flat_equal(wire.flatten_tree(ptree),
                       bridge.tree_to_numpy(tiny["tdp"]))
    tensors = wire.tree_to_tensors(ptree, "cpu")
    want = bridge.flat(tiny["tdp"])
    assert set(bridge.flat(tensors)) == set(want)
    for k, t in bridge.flat(tensors).items():
        assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k


def test_init_frames_cross(tiny):
    """INIT: the frozen embedding under ``e/`` and the draft under
    ``p/``, encoded by either package, decode to the same flat arrays in
    the other."""
    jd = jckpt._flatten(tiny["jdp"])
    jinit = {"e/tok": tiny["embed"]}
    jinit.update({f"p/{k}": np.asarray(v) for k, v in jd.items()})
    pinit = {f"e/{k}": v for k, v in wire.flatten_tree(
        {"tok": torch.from_numpy(tiny["embed"])}).items()}
    pinit.update({f"p/{k}": v for k, v in
                  wire.flatten_tree(tiny["tdp"]).items()})
    a = jwire.decode_npz(_frames_of(encode_frame(
        wire.FT_INIT, wire.npz_payload(pinit)), jwire.FrameReader())[0][2])
    b = decode_npz(_frames_of(jwire.encode_frame(
        wire.FT_INIT, jwire.npz_payload(jinit)), FrameReader())[0][2])
    _assert_flat_equal(a, jinit)
    _assert_flat_equal(b, jinit)


# ============================================================ bf16, views
def test_bf16_draft_roundtrips_bit_for_bit():
    """A bf16 draft travels as its 16-bit words (what np.savez writes for
    JAX's bf16): ``torch.equal`` after the round trip, at 2 bytes a
    parameter plus the container."""
    dcfg = eagle.draft_config(get("tide-tiny"))
    import dataclasses
    dcfg = dataclasses.replace(dcfg, dtype="bfloat16")
    dp = eagle.draft_init(dcfg, 3, device="cpu")
    flat = bridge.flat(dp)
    assert all(t.dtype == torch.bfloat16 for t in flat.values())
    payload = draft_payload(2, dp, 0.5)
    n_params = sum(t.numel() for t in flat.values())
    assert 2 * n_params < len(payload) < 2 * n_params + 300 * (len(flat) + 2)
    seq, tree, acc = decode_draft(payload)
    assert all(a.dtype == bridge.BF16_WORD
               for a in wire.flatten_tree(tree).values())
    back = bridge.flat(wire.tree_to_tensors(tree, "cpu"))
    assert set(back) == set(flat)
    for k, t in back.items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, flat[k]), k
    # what np.load makes of it: the same words (JAX reads its bf16 so)
    with np.load(io.BytesIO(payload)) as data:
        for k, t in flat.items():
            np.testing.assert_array_equal(
                data[f"p/{k}"].view(np.int16), t.view(torch.int16).numpy())


def test_host_array_bf16_words_and_views():
    t = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    a = bridge.host_array(t)
    assert a.dtype == bridge.BF16_WORD
    assert torch.equal(bridge.array_tensor(a, "cpu"), t)
    f = np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4))
    arrays = {"f": f, "s": np.asarray(7, np.int64), "e": np.zeros((0, 3)),
              "u": np.asarray("tide-signals/v1"), "b": np.array([True])}
    out = decode_npz(wire.npz_payload(arrays))
    _assert_flat_equal(out, arrays)
    assert out["f"].flags.f_contiguous
    comp = io.BytesIO()
    np.savez_compressed(comp, **arrays)      # deflated: read by np.load
    _assert_flat_equal(decode_npz(comp.getvalue()), arrays)


def _pair_send(blobs):
    a, b = socket.socketpair()

    def send():
        for blob in blobs:
            a.sendall(blob)
        a.close()
    t = threading.Thread(target=send, daemon=True)
    t.start()
    return b, t


def test_recv_frames_large_frame_in_one_piece():
    rng = np.random.default_rng(5)
    big = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    blobs = [encode_frame(FT_HELLO, b"hi"), encode_frame(FT_DRAFT, big),
             encode_frame(FT_BYE)]
    sock, t = _pair_send(blobs)
    out = list(wire.recv_frames(sock, FrameReader(), bufsize=4096))
    t.join(timeout=10.0)
    sock.close()
    assert [(f, bytes(p)) for f, _, p in out] == [
        (FT_HELLO, b"hi"), (FT_DRAFT, big), (FT_BYE, b"")]
    assert isinstance(out[1][2], memoryview)


def test_recv_frames_partial_and_corrupt_large_frames():
    big = bytes(range(256)) * 400
    frame = encode_frame(FT_DRAFT, big)
    sock, t = _pair_send([frame[:50_000]])
    reader = FrameReader()
    assert list(wire.recv_frames(sock, reader, bufsize=1024)) == []
    t.join(timeout=10.0)
    sock.close()
    assert reader.pending_bytes == 50_000     # kept, as a short feed is
    bad = bytearray(frame)
    bad[-5] ^= 0x10
    sock, t = _pair_send([bytes(bad)])
    reader = FrameReader()
    with pytest.raises(WireError, match="CRC"):
        list(wire.recv_frames(sock, reader, bufsize=1024))
    t.join(timeout=10.0)
    sock.close()
    with pytest.raises(WireError, match="poisoned"):
        _drain(reader, b"")


def test_send_frame_sends_header_then_payload():
    a, b = socket.socketpair()
    payload = wire.npz_payload({"x": np.arange(5000, dtype=np.float32)})
    n = wire.send_frame(a, FT_DRAFT, payload)
    wire.send_frame(a, FT_BYE)
    a.close()
    out = list(wire.recv_frames(b, FrameReader()))
    b.close()
    assert n == HEADER.size + len(payload)
    assert [f for f, _, _ in out] == [FT_DRAFT, FT_BYE]
    np.testing.assert_array_equal(decode_npz(out[0][2])["x"],
                                  np.arange(5000, dtype=np.float32))
