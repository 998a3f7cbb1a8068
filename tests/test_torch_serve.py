"""The port's HTTP server (``cognitive_aim_tpu_torch.serve``) on loopback,
``port=0``, with a tiny engine on the CPU: ``tests/test_serve.py``'s seven
cases restated with the same names and purposes, then the server against
the engine's own batched forward and the JAX server's request handling.

Where the JAX tests count a compile cache (``test_dispatcher_hits_warmup_cache``,
``test_predict_batch_ignores_client_batch_size``), the port's hold the
semantics the count stood for: the warmup ran before the first request, and
every forward the server ran had the one shape ``max_batch``
(``engine.batch_sizes``).
"""

import base64
import json
import threading
import urllib.request

import numpy as np
import pytest
import yaml


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config
    from cognitive_aim_tpu_torch.serve import serve

    tmp = tmp_path_factory.mktemp("serve")
    cfg = {"dataset": {"image_size": 56}, "exif_config": {"num_cameras": 3},
           "focal_config": {"num_iterations": 2}}
    cfg_path = str(tmp / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    vit = DinoV2Config(hidden_size=64, num_layers=2, num_heads=4,
                       pretrain_image_size=56, patch_size=14)
    engine = CognitiveAimInference(
        cfg_path, None, "cpu", noise_mode="zeros", save_images=False, vit_cfg=vit,
    )
    httpd, batcher = serve(engine, port=0, max_batch=4, max_delay_ms=20, data_root=tmp)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}", tmp, engine, batcher
    httpd.shutdown()
    httpd.server_close()
    batcher.stop()


def _post(url, obj, timeout=120):
    req = urllib.request.Request(
        url, json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _jpeg_bytes(tmp, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 255, (80, 60, 3), np.uint8))
    p = tmp / f"img{seed}.jpg"
    img.save(p)
    return p.read_bytes(), str(p)


def _status(base, path, obj):
    req = urllib.request.Request(
        base + path, json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        urllib.request.urlopen(req, timeout=30)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    return 200, None


# --------------------------------------------- tests/test_serve.py, restated ----
def test_healthz(server):
    base, _, _, _ = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok"
    assert h["image_size"] == 56
    assert h["max_batch"] == 4


def test_predict_b64_and_concurrent_batching(server):
    base, tmp, _, _ = server
    raw, _ = _jpeg_bytes(tmp, 1)
    b64 = base64.b64encode(raw).decode()
    out = _post(base + "/predict", {"image_b64": b64, "instruction": "center"})
    assert out["depth"] > 0 and 0 <= out["confidence"] <= 1

    # concurrent mixed-instruction requests ride one micro-batch
    results = {}

    def call(name):
        results[name] = _post(base + "/predict", {"image_b64": b64, "instruction": name})

    threads = [threading.Thread(target=call, args=(n,)) for n in ("left", "right", "top")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert set(results) == {"left", "right", "top"}
    assert all(r["depth"] > 0 for r in results.values())


def test_dispatcher_hits_warmup_cache(server):
    """The padded max_batch forward ran before the server took traffic, and
    the dispatcher's forwards keep that one shape (the JAX test guards a
    silent recompile of the first real batch)."""
    base, tmp, engine, batcher = server
    assert batcher.warmed_up
    raw, _ = _jpeg_bytes(tmp, 9)
    b64 = base64.b64encode(raw).decode()
    n_batches = len(batcher.batches)
    _post(base + "/predict", {"image_b64": b64, "instruction": "bottom"})
    assert len(batcher.batches) > n_batches
    assert set(engine.batch_sizes) == {4}, "the dispatcher ran another batch shape"


def test_predict_batch_paths(server):
    base, tmp, _, _ = server
    _, p1 = _jpeg_bytes(tmp, 2)
    _, p2 = _jpeg_bytes(tmp, 3)
    out = _post(base + "/predict_batch",
                {"paths": [p1, p2], "instruction": "center", "batch_size": 2})
    assert len(out["results"]) == 2
    for d, c in out["results"]:
        assert d > 0 and 0 <= c <= 1


def test_predict_batch_ignores_client_batch_size(server):
    """The device batch size is the server's decision: a hostile sequence of
    client batch_size values runs no forward of another shape; every request
    rides the warmed max_batch shape."""
    base, tmp, engine, _ = server
    paths = [_jpeg_bytes(tmp, 20 + i)[1] for i in range(3)]
    _post(base + "/predict_batch", {"paths": paths, "instruction": "center"})
    assert set(engine.batch_sizes) == {4}
    for hostile in (1, 2, 3, 7, 64):
        out = _post(base + "/predict_batch",
                    {"paths": paths[: max(1, hostile % 4)],
                     "instruction": "left", "batch_size": hostile})
        assert all(d > 0 for d, _ in out["results"])
    assert set(engine.batch_sizes) == {4}, "client batch_size reached the forward shape"


def test_path_outside_data_root_rejected(server):
    """Server-local file reads are gated to the configured data root;
    anything else is a 400, not a file-existence oracle."""
    base, _, _, _ = server
    code, _ = _status(base, "/predict", {"path": "/etc/passwd"})
    assert code == 400


def test_bad_request(server):
    base, _, _, _ = server
    code, body = _status(base, "/predict", {})
    assert code == 400 and "error" in body


# ------------------------------------------------------------ the port ----
def test_served_answers_equal_the_engine_batched_forward(server):
    """Each /predict answer is the engine's own forward of the same image
    (the PIL-resized, normalized pixels) and instruction, padded as the
    dispatcher pads; /predict_batch answers are predict_paths_batched's."""
    import torch

    from cognitive_aim_tpu_torch.models.guidance import instruction_index
    from cognitive_aim_tpu_torch.serve import _decode_request_image

    base, tmp, engine, _ = server
    raw, path = _jpeg_bytes(tmp, 31)
    b64 = base64.b64encode(raw).decode()
    img, exif = _decode_request_image({"image_b64": b64}, engine)
    for name in ("top-right", "bottom"):
        got = _post(base + "/predict", {"image_b64": b64, "instruction": name})
        x = torch.from_numpy(np.repeat(img[None], 4, 0))
        e = engine._to_device({k: np.repeat(np.asarray([v]), 4) for k, v in exif.items()})
        gidx = np.asarray([instruction_index(name), 0, 0, 0])  # padding is 'center'
        out = engine._forward(x, e, engine._guidance(gidx))
        assert got["depth"] == float(out.depth[0, 0])
        assert got["confidence"] == float(out.confidence[0, 0])
    got = _post(base + "/predict_batch", {"paths": [path, path], "instruction": "left"})
    want = engine.predict_paths_batched([path, path], "left", batch_size=4)
    assert [tuple(r) for r in got["results"]] == want


def test_request_errors_match_the_jax_server(server, tmp_path):
    """400 for a bad instruction, a missing 'paths', a path outside the root
    and a broken image; 404 for an unknown path; the same decode as the JAX
    server's (normalized pixels and EXIF scalars)."""
    from cognitive_aim_tpu import serve as JS
    from cognitive_aim_tpu_torch.serve import _check_path_allowed, _decode_request_image

    base, tmp, engine, _ = server
    raw, path = _jpeg_bytes(tmp, 40)
    b64 = base64.b64encode(raw).decode()
    for payload in ({"image_b64": b64, "instruction": "sideways"},
                    {"image_b64": base64.b64encode(b"junk").decode()}):
        assert _status(base, "/predict", payload)[0] in (400, 500)
    assert _status(base, "/predict", {"image_b64": b64, "instruction": "sideways"})[0] == 400
    assert _status(base, "/predict_batch", {"instruction": "left"})[0] == 400
    assert _status(base, "/predict_batch", {"paths": ["/etc/hosts"]})[0] == 400
    assert _status(base, "/nowhere", {})[0] == 404
    for payload in ({"image_b64": b64}, {"path": path}):
        t_img, t_exif = _decode_request_image(payload, engine, tmp)
        j_img, j_exif = JS._decode_request_image(payload, engine, tmp)
        np.testing.assert_array_equal(t_img, j_img)
        assert t_exif == j_exif
    for bad, root in (("/etc/passwd", tmp), (path, None)):
        with pytest.raises(ValueError) as t_err:
            _check_path_allowed(bad, root)
        with pytest.raises(ValueError) as j_err:
            JS._check_path_allowed(bad, root)
        assert str(t_err.value) == str(j_err.value)
    assert _check_path_allowed(path, tmp) == JS._check_path_allowed(path, tmp)


def test_abandoned_waiters_are_dropped_and_timeouts_are_504(tmp_path):
    """A waiter that times out is marked abandoned and gets no device time;
    the handler answers 504."""
    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config
    from cognitive_aim_tpu_torch.serve import BatchingServer, _Pending

    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"dataset": {"image_size": 28}}, f)
    eng = CognitiveAimInference(cfg_path, None, "cpu", noise_mode="zeros", save_images=False,
                                vit_cfg=DinoV2Config(hidden_size=64, num_layers=1,
                                                     num_heads=4, pretrain_image_size=28))
    srv = BatchingServer(eng, max_batch=2, warmup=False)
    srv.stop()  # no dispatcher: nothing answers
    img = np.zeros((28, 28, 3), np.float32)
    exif = {"camera_idx": 0, "focal_length": 50.0, "aperture": 2.8, "iso": 100.0}
    with pytest.raises(TimeoutError):
        srv.submit(img, exif, "center", timeout=0.05)
    p = srv.queue.get_nowait()
    assert isinstance(p, _Pending) and p.abandoned
    assert not srv.warmed_up and not eng.batch_sizes


# ------------------------------------------------------------ the records ----
def _submit_all(srv, n):
    """``n`` requests from ``n`` threads at once, mixed instructions."""
    from cognitive_aim_tpu_torch.models.guidance import INSTRUCTIONS

    img = np.random.RandomState(5).randn(56, 56, 3).astype(np.float32)
    exif = {"camera_idx": 1, "focal_length": 35.0, "aperture": 2.0, "iso": 200.0}
    answers = [None] * n

    def call(i):
        answers[i] = srv.submit(img, exif, INSTRUCTIONS[i % 9], timeout=60)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return answers


def test_batch_records_link_requests_and_tile_their_time(server):
    """Each batch's record lists the ids of its requests, every request once;
    no span is negative and the dispatcher's spans follow one another; each
    request's stages sum to its returned - submitted; the parent's keys
    stay, and the engine's split lies inside its call."""
    from cognitive_aim_tpu_torch.serve import BATCH_SPANS, BatchingServer, stage_ms

    _, _, engine, _ = server
    srv = BatchingServer(engine, max_batch=4, max_delay_ms=20)
    try:
        answers = _submit_all(srv, 10)
    finally:
        srv.stop()
    assert not srv.dispatcher.is_alive() and all(a is not None for a in answers)
    recs = list(srv.batches)
    assert all(b["staged"] is True for b in recs)  # every image fits the kept buffer
    assert [b["id"] for b in recs] == list(range(len(recs)))
    assert sorted(r["id"] for b in recs for r in b["requests"]) == list(range(10))
    order = ["wait", "fill", "stack", "engine", "drain", "reply"]
    for b in recs:
        assert b["n"] == len(b["requests"]) and 1 <= b["n"] <= 4
        assert b["dispatch_ms"] >= 0 and b["drain_ms"] >= 0 and b["captured"] is False
        for k in BATCH_SPANS:
            assert b[k][1] >= b[k][0], (k, b[k])
        for a, c in zip(order, order[1:]):
            assert b[a][1] == b[c][0], (a, c)
        assert b["drain_ms"] == (b["drain"][1] - b["drain"][0]) / 1e6
        e0, e1 = b["engine"]
        assert e0 <= b["lock_wait"][0] and b["copy_out"][1] <= e1
        assert b["copy_in"][1] == b["launch"][0] and b["launch"][1] == b["copy_out"][0]
        closed, drained = b["fill"][1], b["drain"][1]
        for r in b["requests"]:
            assert r["submitted"] <= r["taken"] <= closed <= drained <= r["answered"]
            assert r["answered"] <= b["reply"][1] and r["answered"] <= r["returned"]
            stages = [r["taken"] - r["submitted"], closed - r["taken"],
                      *(b[k][1] - b[k][0] for k in ("stack", "engine", "drain")),
                      r["answered"] - drained, r["returned"] - r["answered"]]
            assert min(stages) >= 0
            assert abs(sum(stages) - (r["returned"] - r["submitted"])) <= 1_000_000
    means = stage_ms(recs)
    assert all(np.isfinite(v) and v >= 0 for v in means.values()), means


def test_a_record_lands_on_the_profiler_host_clock(server):
    """``epoch_ns`` places a request's ``submitted`` inside the profiler's
    range around its ``submit``, on the Unix-epoch clock of kineto's host
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from cognitive_aim_tpu_torch.serve import BatchingServer

    _, _, engine, _ = server
    srv = BatchingServer(engine, max_batch=4, max_delay_ms=1, warmup=False)
    img = np.zeros((56, 56, 3), np.float32)
    exif = {"camera_idx": 0, "focal_length": 50.0, "aperture": 2.8, "iso": 100.0}
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("caim.test_submit"):
                srv.submit(img, exif, "center", timeout=60)
    finally:
        srv.stop()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU and e.name() == "caim.test_submit"]
    (rec,) = list(srv.batches)
    r = rec["requests"][0]
    slack = 2_000_000  # ns: the two clocks' readings are not simultaneous
    assert ev.start_ns() - slack <= srv.epoch_ns(r["submitted"]) <= ev.end_ns() + slack
    assert ev.start_ns() - slack <= srv.epoch_ns(r["returned"]) <= ev.end_ns() + slack


# ------------------------------------------------------ the kept buffer ----
EXIF = {"camera_idx": 2, "focal_length": 35.0, "aperture": 2.0, "iso": 200.0}


def _one_batch(srv, imgs, names):
    """``imgs`` from as many threads at once, which the dispatcher's long
    ``max_delay_ms`` keeps in one batch; the answers in order."""
    answers = [None] * len(imgs)

    def call(i):
        answers[i] = srv.submit(imgs[i], EXIF, names[i], timeout=60)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return answers


def _spied(monkeypatch, engine):
    """The engine's ``_forward`` and a list that gets a copy of the inputs
    of each later call (the kept buffer is refilled after it)."""
    forward, calls = engine._forward, []

    def spy(images, exif, guidance=None):
        calls.append((images.clone(), {k: v.clone() for k, v in exif.items()}, guidance.clone()))
        return forward(images, exif, guidance)

    monkeypatch.setattr(engine, "_forward", spy)
    return forward, calls


def _assert_the_stacked_batch(forward, call, imgs, names, answers, max_batch):
    """The images the engine got are ``np.stack`` of the batch's images in
    the dispatcher's order, padded with ``np.repeat`` of the last, and each
    answer is the engine's forward of that stacked batch, bit for bit."""
    import torch

    from cognitive_aim_tpu_torch.models.guidance import instruction_index

    got, exif, g = call
    n = len(imgs)
    order = [next(i for i in range(n) if np.array_equal(row, imgs[i])) for row in got[:n].numpy()]
    assert sorted(order) == list(range(n))
    stacked = np.stack([imgs[i] for i in order])
    stacked = np.concatenate([stacked, np.repeat(stacked[-1:], max_batch - n, axis=0)])
    assert np.array_equal(got.numpy(), stacked)
    assert g.tolist() == [instruction_index(names[i]) for i in order] + [0] * (max_batch - n)
    want = forward(torch.from_numpy(stacked), exif, g)
    for row, i in enumerate(order):
        assert answers[i] == (float(want.depth[row, 0]), float(want.confidence[row, 0]))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_staged_batches_are_the_stacked_batches(server, monkeypatch, n):
    """A full batch, then one of ``n``, through the kept buffer: the engine
    gets the bytes ``np.stack`` and the pad give (no row of the earlier
    batch left in the pad) and each answer is its forward of them."""
    from cognitive_aim_tpu_torch.models.guidance import INSTRUCTIONS
    from cognitive_aim_tpu_torch.serve import BatchingServer

    _, _, engine, _ = server
    rng = np.random.RandomState(60 + n)
    full = [rng.randn(56, 56, 3).astype(np.float32) for _ in range(4)]
    small = [rng.randn(56, 56, 3).astype(np.float32) for _ in range(n)]
    srv = BatchingServer(engine, max_batch=4, max_delay_ms=1000)
    forward, calls = _spied(monkeypatch, engine)
    try:
        sent = [(full, INSTRUCTIONS[:4]), (small, INSTRUCTIONS[4:4 + n])]
        answers = [_one_batch(srv, imgs, names) for imgs, names in sent]
    finally:
        srv.stop()
    assert [(b["n"], b["staged"]) for b in srv.batches] == [(4, True), (n, True)]
    assert len(calls) == 2
    for call, (imgs, names), got in zip(calls, sent, answers):
        _assert_the_stacked_batch(forward, call, imgs, names, got, 4)


def test_an_image_of_another_shape_is_stacked(server, monkeypatch):
    """A request whose image is not the buffer's shape takes the stack of
    fresh arrays (``staged`` False) and is answered as the engine's forward
    of that stack; the next batch fits the buffer again."""
    from cognitive_aim_tpu_torch.serve import BatchingServer

    _, _, engine, _ = server
    rng = np.random.RandomState(70)
    odd = [rng.randn(28, 28, 3).astype(np.float32)]
    fits = [rng.randn(56, 56, 3).astype(np.float32)]
    srv = BatchingServer(engine, max_batch=4, max_delay_ms=1)
    forward, calls = _spied(monkeypatch, engine)
    try:
        answers = [_one_batch(srv, imgs, ["left"]) for imgs in (odd, fits)]
    finally:
        srv.stop()
    assert [b["staged"] for b in srv.batches] == [False, True]
    assert calls[0][0].shape == (4, 28, 28, 3) and not srv._staging.is_pinned()
    for call, imgs, got in zip(calls, (odd, fits), answers):
        _assert_the_stacked_batch(forward, call, imgs, ["left"], got, 4)
