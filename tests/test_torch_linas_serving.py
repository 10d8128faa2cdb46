"""The port's retrieval CLIs, host modules and HTTP retrieval route against
the JAX package's, on a tiny collection on the CPU.

Each host module the port copied (vocab, text2vec, bigfile, provider,
metrics/retrieval, evaluation, batching) gives the JAX module's output on
the same input; `retrieval_inference.main` prints the JAX CLI's top-K ids;
`retrieval_tester.evaluate` gives its report within 1e-4; an index cache
the JAX CLI wrote loads in the port; the port's server, over real HTTP,
answers /retrieval with the JAX handler's ids; the flags of routes that are
not ported raise; and the serving bench runs tiny on the CPU."""

import argparse
import json
import os
import pickle
import random
import threading

import numpy as np
import pytest
import torch

from fixtures import make_checkpoint, make_collection

from cross_modal_video_engine_tpu.cli import retrieval_inference as jri
from cross_modal_video_engine_tpu.cli import retrieval_tester as jrt
from cross_modal_video_engine_tpu.cli import serve as jserve
from cross_modal_video_engine_tpu.cli.common import load_dataset as j_load
from cross_modal_video_engine_tpu.data import provider as jprov
from cross_modal_video_engine_tpu.io import bigfile as jbig
from cross_modal_video_engine_tpu.metrics import retrieval as jmet
from cross_modal_video_engine_tpu.retrieval import evaluation as jev
from cross_modal_video_engine_tpu.service import batching as jbat
from cross_modal_video_engine_tpu.utils import text2vec as jt2v
from cross_modal_video_engine_tpu.utils import vocab as jvoc
from cross_modal_video_engine_tpu_torch.bench import serve as bserve
from cross_modal_video_engine_tpu_torch.cli import retrieval_inference as tri
from cross_modal_video_engine_tpu_torch.cli import retrieval_tester as trt
from cross_modal_video_engine_tpu_torch.cli import serve as tserve
from cross_modal_video_engine_tpu_torch.cli.common import (
    load_dataset as t_load, restore_dual_encoding)
from cross_modal_video_engine_tpu_torch.data import provider as tprov
from cross_modal_video_engine_tpu_torch.io import bigfile as tbig
from cross_modal_video_engine_tpu_torch.metrics import retrieval as tmet
from cross_modal_video_engine_tpu_torch.models.dual_encoding import (
    DualEncodingConfig)
from cross_modal_video_engine_tpu_torch.retrieval import evaluation as tev
from cross_modal_video_engine_tpu_torch.service import app as tapp
from cross_modal_video_engine_tpu_torch.service import batching as tbat
from cross_modal_video_engine_tpu_torch.utils import text2vec as tt2v
from cross_modal_video_engine_tpu_torch.utils import vocab as tvoc

QUERIES = ["a dog runs fast", "red car on the road", "zzz unknown", "",
           "big blue ball"]


@pytest.fixture(autouse=True)
def _torch_state_kept():
    """Each test leaves torch's global RNG and thread count as found."""
    rng, threads = torch.get_rng_state(), torch.get_num_threads()
    yield
    assert torch.equal(torch.get_rng_state(), rng)
    assert torch.get_num_threads() == threads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tiny collection and a LINAS checkpoint the JAX package wrote."""
    root = str(tmp_path_factory.mktemp("linas"))
    info = make_collection(root)
    ckpt, cfg = make_checkpoint(root, info)
    return root, info, ckpt


def _args(root, info, ckpt, **kw):
    return argparse.Namespace(
        retrieval_checkpoint=ckpt, rootpath=root,
        collection=info["collection"], visual_feature=info["feature"],
        index_cache=None, max_batch=8, device="cpu", **kw)


# -- host modules --------------------------------------------------------------

def test_vocab_matches_jax(tmp_path):
    caps = ["A dog, runs!", "the dog and the cat", "cat-cat  DOG"]
    for style, threshold in (("rnn", 1), ("bow", 2)):
        jv, jc = jvoc.build_vocab(caps, style, threshold)
        tv, tc = tvoc.build_vocab(caps, style, threshold)
        assert jv.word2idx == tv.word2idx and jc == tc
        for cap in caps + ["unknown words"]:
            if style == "rnn":
                assert jvoc.caption_to_ids(jv, cap) == \
                    tvoc.caption_to_ids(tv, cap)
        tv.save(str(tmp_path / f"{style}.json"))
        assert jvoc.Vocabulary.load(str(tmp_path / f"{style}.json")
                                    ).word2idx == tv.word2idx
    assert tvoc.clean_str("Hi-there 3x!") == jvoc.clean_str("Hi-there 3x!")
    assert tvoc.captions_from_txt is not None


def test_vocab_loads_reference_pickles(tmp_path):
    """A pickle whose class is recorded as __main__.Vocabulary loads."""
    class Vocabulary:           # what the reference's util/vocab.py pickles
        pass
    Vocabulary.__module__, Vocabulary.__qualname__ = "__main__", "Vocabulary"
    obj = Vocabulary()
    obj.word2idx = {"<pad>": 0, "dog": 1}
    obj.idx2word = {0: "<pad>", 1: "dog"}
    obj.text_style = "rnn"
    import __main__
    setattr(__main__, "Vocabulary", Vocabulary)
    try:
        data = pickle.dumps(obj)
    finally:
        delattr(__main__, "Vocabulary")
    path = str(tmp_path / "v.pkl")
    with open(path, "wb") as f:
        f.write(data)
    assert tvoc.Vocabulary.load(path).word2idx == \
        jvoc.Vocabulary.load(path).word2idx == obj.word2idx


def test_text2vec_matches_jax(world):
    root, info, _ = world
    tbow = tt2v.Bow2Vec(info["bow_vocab"], l2_norm=True)
    jbow = jt2v.Bow2Vec(info["bow_vocab"], l2_norm=True)
    np.testing.assert_array_equal(tbow.batch_mapping(QUERIES),
                                  jbow.batch_mapping(QUERIES))
    assert tbow.mapping("zzz") is None and jbow.mapping("zzz") is None
    assert tt2v.get_text_encoder("bow") is tt2v.Bow2Vec
    assert sorted(tt2v.TEXT_ENCODERS) == sorted(jt2v.TEXT_ENCODERS.keys())
    with pytest.raises(KeyError, match="word2vec"):
        tt2v.get_text_encoder("nope")


def test_bigfile_matches_jax(world, tmp_path):
    root, info, _ = world
    jb, tb = jbig.BigFile(info["feat_dir"]), tbig.BigFile(info["feat_dir"])
    names = tb.names[::3] + ["missing"]
    jn, jv = jb.read(names)
    tn, tv = tb.read(names)
    assert jn == tn
    np.testing.assert_array_equal(np.stack(jv), np.stack(tv))
    np.testing.assert_array_equal(jb.read_batch(jn), tb.read_batch(tn))
    assert tb.shape() == jb.shape()
    rows = [v for _, v in tbig.StreamFile(info["feat_dir"])]
    np.testing.assert_array_equal(np.stack(rows), jb.read_batch(jb.names))
    tbig.write_bigfile(str(tmp_path / "w"), ["a", "b"],
                       np.eye(2, 3, dtype=np.float32))
    np.testing.assert_array_equal(
        jbig.BigFile(str(tmp_path / "w")).read_batch(["b"]), [[0, 1, 0]])


def test_provider_matches_jax(world, tmp_path):
    root, info, _ = world
    jds = j_load(root, info["collection"], info["feature"], max_words=6)
    tds = t_load(root, info["collection"], info["feature"], max_words=6,
                 device="cpu")
    assert jds.video_ids == tds.video_ids and jds.cap_ids == tds.cap_ids
    assert tprov.get_video_id("v1#3") == jprov.get_video_id("v1#3") == "v1"
    for (jb, jn), (tb, tn) in zip(jds.video_batches(5), tds.video_batches(5)):
        assert jn == tn
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for (jb, jn), (tb, tn) in zip(jds.text_batches(7), tds.text_batches(7)):
        assert jn == tn
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jtr = list(jds.train_batches(4, seed=3))
    ttr = list(tds.train_batches(4, seed=3))
    assert len(jtr) == len(ttr)
    for j, t in zip(jtr, ttr):
        assert j[3] == t[3]
        for jpart, tpart in zip(j[:3], t[:3]):
            for a, b in zip(jpart, tpart):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    lines = tmp_path / "v2f.txt"
    lines.write_text("v1 f1 f2\nv2 f3\n")
    assert tprov.read_video2frames(str(lines)) == \
        jprov.read_video2frames(str(lines)) == {"v1": ["f1", "f2"],
                                                "v2": ["f3"]}
    rng_t, rng_j = random.Random(5), random.Random(5)
    cid = tds.cap_ids[0]
    assert tds.support_for(cid, rng_t) == jds.support_for(cid, rng_j)


@pytest.mark.parametrize("n_caption", [1, 2, 5])
def test_metrics_match_jax(n_caption):
    rng = np.random.default_rng(41)
    n_vid = 7
    errors = rng.standard_normal((n_vid * n_caption, n_vid))
    errors[0, :2] = errors[0, 3]                    # ties
    assert jmet.t2v(errors, n_caption) == tmet.t2v(errors, n_caption)
    assert jmet.v2t(errors, n_caption) == tmet.v2t(errors, n_caption)
    vids = [f"v{i}" for i in range(n_vid)]
    caps = [f"v{i}#{c}" for i in range(n_vid) for c in range(n_caption)]
    assert jmet.get_gt(vids, caps) == tmet.get_gt(vids, caps)
    v2t_gt, t2v_gt = tmet.get_gt(vids, caps)
    assert jmet.cal_perf(errors, v2t_gt, t2v_gt) == \
        tmet.cal_perf(errors, v2t_gt, t2v_gt)
    labels = rng.random((6, 9)) > 0.7
    assert jmet.recall_at_k_from_labels(labels) == \
        tmet.recall_at_k_from_labels(labels)


def test_evaluation_helpers_match_jax():
    rng = np.random.default_rng(42)
    e = rng.standard_normal((5, 4)).astype(np.float32)
    np.testing.assert_array_equal(jev.norm_score(e), tev.norm_score(e))
    batches = [rng.standard_normal((3, 4)).astype(np.float32)
               for _ in range(3)]
    want = jev.encode_batched(lambda b: b, batches, 8, 4)
    got = tev.encode_batched(torch.from_numpy, batches, 8, 4)
    np.testing.assert_array_equal(got, want)


def test_batching_matches_jax():
    for n, cap in ((1, 8), (3, 8), (8, 8), (9, 8), (5, 4)):
        assert tbat._pad_pow2(n, cap) == jbat._pad_pow2(n, cap)
    rows = [np.full(3, i, np.float32) for i in range(5)]
    fn_t = tbat.make_padded_array_fn(lambda b: b * 2 + len(b), 16)
    fn_j = jbat.make_padded_array_fn(lambda b: b * 2 + len(b), 16)
    for a, b in zip(fn_t(rows), fn_j(rows)):
        np.testing.assert_array_equal(a, b)
    for rows_n in (1, 3, 8, 40):
        got = tserve._pow2_rows(list(range(rows_n)), 32, 8)
        assert got == jserve._pow2_rows(list(range(rows_n)), 32, 8)
        assert tserve._pow2_rows(list(range(rows_n)), 32, 1) == \
            jserve._pow2_rows(list(range(rows_n)), 32, 1)


def test_micro_batcher_coalesces_and_fans_out():
    """Many threads, one worker: every row gets its own result, waves
    never exceed max_batch, and a short result list fails every row."""
    batcher = tbat.MicroBatcher(lambda rows: [r * 10 for r in rows],
                                max_batch=4, max_wait_ms=20)
    out = [None] * 24
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, batcher.submit(i, timeout=30))) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert out == [i * 10 for i in range(24)]
    assert batcher.rows_run == 24 and batcher.batches_run >= 6
    batcher.close()
    short = tbat.MicroBatcher(lambda rows: rows[:-1], max_batch=2)
    with pytest.raises(RuntimeError, match="results"):
        short.submit(1, timeout=30)
    short.close()
    with pytest.raises(RuntimeError, match="closed"):
        short.submit(1)


# -- the CLIs ----------------------------------------------------------------------

@pytest.mark.parametrize("query", QUERIES[:3])
def test_inference_cli_matches_jax(world, query, tmp_path, capsys):
    root, info, ckpt = world
    argv = ["--checkpoint", ckpt, "--rootpath", root,
            "--collection", info["collection"],
            "--visual_feature", info["feature"], "--input", query,
            "--topK", "5"]
    want = jri.main(argv)
    got = tri.main(argv + ["--device", "cpu"])
    assert list(got) == list(want)
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[:5] == printed[5:]        # the same ids and scores


def test_index_cache_written_by_jax_loads_in_the_port(world, tmp_path):
    root, info, ckpt = world
    cache = str(tmp_path / "video_index.npz")
    argv = ["--checkpoint", ckpt, "--rootpath", root,
            "--collection", info["collection"],
            "--visual_feature", info["feature"], "--input", "red car",
            "--topK", "4", "--index_cache", cache]
    want = jri.main(argv)
    assert os.path.exists(cache)
    model, _ = restore_dual_encoding(ckpt, device="cpu")
    ds = t_load(root, info["collection"], info["feature"], device="cpu")
    index = tri.build_video_index(model, ds, cache=cache)
    np.testing.assert_allclose(index.emb[: index.n].numpy(),
                               np.load(cache)["emb"], rtol=0, atol=1e-6)
    assert tri.main(argv + ["--device", "cpu"]) == list(want)


def test_tester_matches_jax(world, tmp_path):
    root, info, ckpt = world
    model, _ = restore_dual_encoding(ckpt, device="cpu")
    ds = t_load(root, info["collection"], info["feature"], device="cpu")
    errors, report = trt.evaluate(model, ds, batch_size=4)
    argv = ["--checkpoint", ckpt, "--rootpath", root,
            "--testCollection", info["collection"],
            "--visual_feature", info["feature"], "--batch_size", "4"]
    want = jrt.main(argv + ["--output_dir", str(tmp_path / "jax")])
    got = trt.main(argv + ["--output_dir", str(tmp_path / "port"),
                           "--device", "cpu"])
    assert got == report
    want_err = np.load(str(tmp_path / "jax" / "pred_errors_matrix.npz"))
    np.testing.assert_allclose(errors, want_err["errors"], rtol=0, atol=1e-4)
    for d in ("t2v", "v2t"):
        for key, value in want[d].items():
            assert got[d][key] == pytest.approx(value, abs=1e-4), (d, key)
    assert got["rsum"] == pytest.approx(want["rsum"], abs=1e-4)
    with open(tmp_path / "port" / "test_report.json") as f:
        assert json.load(f) == got


# -- serving -----------------------------------------------------------------------

def test_server_answers_like_the_jax_handler(world):
    """The port's server on the CPU over real HTTP, against the JAX
    retrieval handler on the same checkpoint and collection."""
    root, info, ckpt = world
    service = tserve.build_service(_args(root, info, ckpt, max_wait_ms=5.0))
    assert sorted(service.handlers) == ["retrieval"]
    jh = jserve.build_retrieval_handler(_args(root, info, ckpt))
    server, _ = tapp.serve_in_thread(service, port=0)
    port = server.server_address[1]
    try:
        _, health = bserve.request(port, "health")
        assert health == {"status": "ok", "routes": ["retrieval"]}
        for q in QUERIES:
            _, got = bserve.request(port, "retrieval", {"query": q,
                                                        "topK": 4})
            want = jh({"query": q, "topK": 4})
            assert [r["video"] for r in got["results"]] == \
                [r["video"] for r in want["results"]]
            np.testing.assert_allclose(
                [r["score"] for r in got["results"]],
                [r["score"] for r in want["results"]], rtol=0, atol=1e-5)
        # a concurrent burst is coalesced and answers every request
        lat = bserve.concurrent(port, QUERIES, clients=8, per_client=2,
                                top_k=3)
        assert len(lat) == 16
        _, metrics = bserve.request(port, "metrics")
        assert metrics["retrieval"]["requests"] == len(QUERIES) + 16
        assert metrics["retrieval"]["errors"] == 0
    finally:
        server.shutdown()
        server.server_close()
        service.handlers["retrieval"].batcher.close()
        jh.batcher.close()


def test_wave_k_follows_the_jax_route():
    assert tserve.wave_k([3], 1000) == 16
    assert tserve.wave_k([3, 17], 1000) == 32
    assert tserve.wave_k([10], 12) == 12


@pytest.mark.parametrize("flag", ["caption_checkpoint",
                                  "explain_checkpoint", "demo"])
def test_routes_not_ported_raise(flag, tmp_path, monkeypatch):
    """No route is left unported: the caption and explain routes read
    their checkpoints (a missing one raises FileNotFoundError), and
    `--demo` hands the demo pages' directory to create_server."""
    if flag == "demo":
        seen = {}

        def fake_create_server(service, host, port, demo_dir=None):
            seen.update(handlers=dict(service.handlers), demo_dir=demo_dir)
            raise KeyboardInterrupt        # stop before serving

        monkeypatch.setattr(tserve, "create_server", fake_create_server)
        with pytest.raises(KeyboardInterrupt):
            tserve.main(["--demo", "--device", "cpu"])
        assert seen == {"handlers": {}, "demo_dir": tserve.DEMO_DIR}
        return
    missing = str(tmp_path / "missing")
    for build in (lambda: tserve.build_service(argparse.Namespace(
            **{flag: missing, "device": "cpu"})),
                  lambda: tserve.main([f"--{flag}", missing,
                                       "--device", "cpu"])):
        with pytest.raises(FileNotFoundError, match="missing"):
            build()


def test_serving_bench_runs_on_the_cpu(tmp_path, capsys):
    """bench/serve.py end to end at a tiny width: fixtures, index filled
    to --rows, both HTTP arms, the two timed waves, /metrics."""
    cfg = DualEncodingConfig(
        visual_feat_dim=12, visual_rnn_size=6, visual_kernel_num=4,
        vocab_size=50, bow_vocab_size=30, word_dim=8, text_rnn_size=6,
        text_kernel_num=4, hidden_size=8, common_dim=16)
    rows = bserve.run(rows=500, videos=10, device="cpu", root=str(tmp_path),
                      cfg=cfg, n_single=6, clients=4, per_client=2,
                      wave_calls=2)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == rows
    names = [r["metric"] for r in rows]
    assert names == ["serve_retrieval_batch1",
                     "serve_retrieval_handler_batch1",
                     "serve_retrieval_conc4", "serve_retrieval_wave1",
                     "serve_retrieval_wave8", "serve_metrics"]
    assert all(r["device"] == "cpu" and r["rows"] == 500 for r in rows)
    assert rows[1]["n"] == 6
    assert rows[2]["n"] == 8 and rows[2]["waves"] >= 1
    assert rows[3]["busy_ms"] is None and rows[3]["unit"] == "ms/cpu"
    assert rows[4]["wave_rows"] == 8
    # /metrics counts the HTTP requests only
    assert rows[5]["value"]["retrieval"]["requests"] == 6 + 8
    assert os.listdir(tmp_path) == []          # fixtures removed
