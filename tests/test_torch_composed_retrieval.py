"""The port's composed-retrieval host code, CLI and HTTP route against the
JAX package's, on the CPU at tiny widths.

The pooling helpers, FeatureStore (npz and h5), ComposedVideoDataset and
the video reader give the JAX copies' outputs on the same inputs;
`composed_inference.main` prints the JAX CLI's top-K on the same
checkpoint files and videos (the RN50x4 layout with the conv4x4 Combiner,
and a bf16 ViT with the dense one); the route over HTTP answers as a
direct `rank_index` does; the serve flags of unported routes still raise;
and the composed arm of bench/serve.py runs tiny on the CPU.

Tolerances: pooling in f32 within 1e-6 (means of the same elements in
another order); top-K lists equal."""

import argparse
import json
import os
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cross_modal_video_engine_tpu.cli import composed_inference as jci
from cross_modal_video_engine_tpu.data import composed_dataset as jcd
from cross_modal_video_engine_tpu.io import video_decode as jvd
from cross_modal_video_engine_tpu_torch.bench import serve as bserve
from cross_modal_video_engine_tpu_torch.cli import composed_inference as tci
from cross_modal_video_engine_tpu_torch.cli import serve as tserve
from cross_modal_video_engine_tpu_torch.data import composed_dataset as tcd
from cross_modal_video_engine_tpu_torch.io import video_decode as tvd
from cross_modal_video_engine_tpu_torch.models import clip as tclip
from cross_modal_video_engine_tpu_torch.models import clip_resnet as trn
from cross_modal_video_engine_tpu_torch.models import combiner as tcomb
from cross_modal_video_engine_tpu_torch.service.app import create_server

RN = trn.CLIPResNetConfig(embed_dim=24, vision_layers=(1, 2, 2, 1),
                          vision_width=16, image_resolution=64,
                          context_length=12, vocab_size=800, text_width=16,
                          text_heads=2, text_layers=1)
VIT = tclip.CLIPConfig(embed_dim=32, image_resolution=64, vision_width=48,
                       vision_layers=2, vision_heads=4, patch_size=16,
                       context_length=12, vocab_size=800, text_width=40,
                       text_heads=4, text_layers=2, dtype="bfloat16")
EDITS = ["make the video red", "a dog instead", "at night"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread (the lane runs several xdist workers), and torch's
    global RNG and thread count left as found."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


# -- pooling, features, dataset -----------------------------------------------

@pytest.mark.parametrize("n,out", [(7, 3), (324, 16), (16, 16), (5, 8)])
def test_adaptive_pool_axis_is_jax_copy_and_torch(n, out):
    x = np.random.default_rng(n).standard_normal((2, n, 3)).astype(
        np.float32)
    got = tcd.adaptive_avg_pool_axis(x, out, axis=1)
    np.testing.assert_array_equal(got, jcd.adaptive_avg_pool_axis(x, out, 1))
    want = F.adaptive_avg_pool1d(torch.from_numpy(x).transpose(1, 2), out)
    np.testing.assert_allclose(got, want.transpose(1, 2).numpy(), rtol=0,
                               atol=1e-6)


def test_pool_middle_and_build_combiner_inputs():
    rng = np.random.default_rng(3)
    high = rng.standard_normal((13, 24)).astype(np.float32)
    middle = rng.standard_normal((13, 36, 256)).astype(np.float32)
    got = tcd.pool_middle_feature(middle, 8, 16, dim=24)
    np.testing.assert_array_equal(
        got, jcd.pool_middle_feature(middle, 8, 16, dim=24))
    want = F.adaptive_avg_pool2d(torch.from_numpy(middle)[None], (16, 24))
    want = F.adaptive_avg_pool3d(want[None], (8, 16, 24))[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the CLI's pooling runs in torch on the features' device
    jh, jm = jci.build_combiner_inputs(high, middle, dim=24)
    th, tm = tci.build_combiner_inputs(torch.from_numpy(high),
                                       torch.from_numpy(middle), dim=24)
    np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ext", [".npz", ".h5"])
def test_feature_store_reads_what_both_write(tmp_path, ext):
    rng = np.random.default_rng(4)
    high = rng.standard_normal((5, 8)).astype(np.float32)
    middle = rng.standard_normal((5, 6, 8)).astype(np.float32)
    tcd.save_video_features(str(tmp_path / ("a" + ext)), high, middle)
    jcd.save_video_features(str(tmp_path / ("b" + ext)), high, middle)
    for store in (tcd.FeatureStore({"main": str(tmp_path)}),
                  jcd.FeatureStore({"main": str(tmp_path)})):
        for name in ("a", "b"):
            h, m = store.load(name)
            np.testing.assert_array_equal(h, high)
            np.testing.assert_array_equal(m, middle)
    with pytest.raises(FileNotFoundError):
        tcd.FeatureStore({"main": str(tmp_path)}).load("missing")


def write_triplets(root, n_videos=6, n_triplets=9, dim=8, seed=5):
    """npz features of n_videos videos (13 frames, 20 tokens) under
    root/feats, triplets over them with a source column, an id map."""
    rng = np.random.default_rng(seed)
    feats = os.path.join(root, "feats")
    os.makedirs(feats)
    for i in range(n_videos):
        tcd.save_video_features(
            os.path.join(feats, f"v{i}.npz"),
            rng.standard_normal((13, dim)).astype(np.float32),
            rng.standard_normal((13, 20, dim)).astype(np.float32))
    lines = []
    for t in range(n_triplets):
        a, b = rng.choice(n_videos, 2, replace=False)
        lines.append(f"id{a}\tv{b}\t{EDITS[t % 3]}\tsrc\tcls")
    tsv = os.path.join(root, "triplets.tsv")
    with open(tsv, "w") as f:
        f.write("\n".join(lines) + "\nbad line\n")
    id2name = os.path.join(root, "id2name.json")
    with open(id2name, "w") as f:
        json.dump({f"id{i}": f"v{i}" for i in range(n_videos)}, f)
    return tsv, feats, id2name


def test_composed_dataset_batches_match_jax(tmp_path):
    tsv, feats, id2name = write_triplets(str(tmp_path))
    tds = tcd.ComposedVideoDataset(tsv, tcd.FeatureStore({"main": feats}),
                                   id2name)
    jds = jcd.ComposedVideoDataset(tsv, jcd.FeatureStore({"main": feats}),
                                   id2name)
    assert tds.video_names == jds.video_names and len(tds) == len(jds) == 9
    for shuffle in (False, True):
        for tb, jb in zip(tds.batches(4, shuffle, seed=2),
                          jds.batches(4, shuffle, seed=2)):
            assert tb.keys() == jb.keys()
            for k in tb:
                np.testing.assert_array_equal(np.asarray(tb[k]),
                                              np.asarray(jb[k]))
    assert tb["n_valid"] == 1 and tb["ref_middle"].shape == (4, 8, 16, 8)
    classic = tcd.ComposedVideoDataset(tsv, tcd.FeatureStore(
        {"main": feats}), id2name, mode="classic")
    i, (h, m) = classic[0]
    jh, jm = jcd.ComposedVideoDataset(tsv, jcd.FeatureStore(
        {"main": feats}), id2name, mode="classic")[0][1]
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(m, jm)


def test_open_video_reads_what_write_test_video_wrote(tmp_path):
    path = str(tmp_path / "v.mp4")
    frames = np.random.default_rng(6).integers(0, 256, (20, 32, 48, 3),
                                               np.uint8)
    tvd.write_test_video(path, frames)
    t, j = tvd.open_video(path), jvd.open_video(path)
    assert len(t) == len(j) == 20 and (t.width, t.height) == (48, 32)
    idx = [5, 0, 5, 19, 3]
    np.testing.assert_array_equal(t.get_batch(idx), j.get_batch(idx))
    t.release()
    j.release()
    got = tci.decode_video_frames(path, stride=8)
    assert got.shape == (3, 32, 48, 3) and got.dtype == np.uint8
    with pytest.raises(FileNotFoundError):
        tvd.open_video(str(tmp_path / "missing.mp4"))


def test_video_decode_imports_cv2_only_when_called():
    import subprocess
    import sys
    code = ("import sys; sys.modules['cv2'] = None\n"
            "from cross_modal_video_engine_tpu_torch.io import video_decode\n"
            "from cross_modal_video_engine_tpu_torch.cli import serve\n"
            "try:\n    video_decode.open_video('x.mp4')\n"
            "except ImportError as e:\n    print('cv2' in str(e))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == "True", out.stderr[-2000:]


# -- the CLI against the JAX CLI ----------------------------------------------

def write_fixture(root, tower: str, n_candidates=3, seed=13):
    """Checkpoints of both packages' format, merges, mp4 videos."""
    rng = np.random.default_rng(seed)
    clip_cfg = RN if tower == "rn50x4" else VIT
    comb_cfg = tcomb.CombinerConfig(
        clip_feature_dim=clip_cfg.embed_dim, projection_dim=16,
        hidden_dim=20,
        middle_mix="conv4x4" if tower == "rn50x4" else "dense")
    paths = argparse.Namespace(
        clip_checkpoint=os.path.join(root, "clip"),
        combiner_checkpoint=os.path.join(root, "comb"),
        merges=os.path.join(root, "merges.txt"),
        videos_dir=os.path.join(root, "videos"),
        feature_cache=os.path.join(root, "cache"),
        ref=os.path.join(root, "ref.mp4"))
    bserve.write_clip_checkpoint(paths.clip_checkpoint, clip_cfg, seed)
    bserve.write_combiner_checkpoint(paths.combiner_checkpoint, comb_cfg,
                                     seed + 1)
    from cross_modal_video_engine_tpu_torch.utils.bpe import write_toy_merges
    write_toy_merges(paths.merges, EDITS, n_merges=16)
    os.makedirs(paths.videos_dir)
    for i in range(n_candidates):
        tvd.write_test_video(os.path.join(paths.videos_dir, f"cand{i}.mp4"),
                             rng.integers(0, 256, (24, 48, 40, 3), np.uint8))
    tvd.write_test_video(paths.ref, rng.integers(0, 256, (24, 48, 40, 3),
                                                 np.uint8))
    return paths


@pytest.mark.parametrize("tower", ["rn50x4", "vit"])
def test_composed_inference_cli_matches_jax(tmp_path, tower):
    p = write_fixture(str(tmp_path), tower)
    common = ["--input_vdo", p.ref, "--input_modified_text", EDITS[0],
              "--videos_dir", p.videos_dir, "--clip_checkpoint",
              p.clip_checkpoint, "--combiner_checkpoint",
              p.combiner_checkpoint, "--merges", p.merges, "--topK", "3"]
    want = jci.main(common)
    got = tci.main(common + ["--device", "cpu", "--output_dir",
                             str(tmp_path / "out"), "--feature_cache",
                             p.feature_cache])
    assert got == want and len(got) == 3
    assert os.path.exists(str(tmp_path / "out" / got[0]))
    # the cache the first run wrote serves the second run, same answer
    assert len(os.listdir(p.feature_cache)) == 3
    again = tci.main(common + ["--device", "cpu", "--feature_cache",
                               p.feature_cache])
    assert again == want


# -- the HTTP route -----------------------------------------------------------

def test_composed_route_over_http_is_a_direct_rank(tmp_path):
    p = write_fixture(str(tmp_path), "rn50x4", n_candidates=5)
    rng = np.random.default_rng(9)
    videos = {os.path.join(p.videos_dir, n): rng.integers(
        0, 256, (9, 40, 56, 3), np.uint8) for n in tci.list_videos(
            p.videos_dir)}
    videos.update({f"ref{i}": rng.integers(0, 256, (9, 40, 56, 3), np.uint8)
                   for i in range(3)})
    args = argparse.Namespace(
        clip_checkpoint=p.clip_checkpoint,
        combiner_checkpoint=p.combiner_checkpoint, merges=p.merges,
        videos_dir=p.videos_dir, feature_cache=None, device="cpu",
        max_batch=4)
    service = tserve.build_service(args, decode=videos.__getitem__)
    handler = service.handlers["composed_retrieval"]
    server = create_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        payloads = [{"reference_video": f"ref{i % 3}", "text": EDITS[i % 3],
                     "topK": 4} for i in range(6)]
        answers = [None] * len(payloads)

        def post(i):
            answers[i] = bserve.request(port, "composed_retrieval",
                                        payloads[i])[1]

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.shutdown()
        server.server_close()
        handler.batcher.close()
    clip_model, clip_cfg = tci.load_clip_tower(p.clip_checkpoint, "cpu")
    combiner = tci.load_combiner(p.combiner_checkpoint, "cpu")
    names, index_high = tci.candidate_index(
        clip_model, clip_cfg.image_resolution, p.videos_dir,
        decode=videos.__getitem__)
    assert names == handler.names
    from cross_modal_video_engine_tpu_torch.utils.bpe import BPETokenizer
    tok = BPETokenizer(p.merges)
    for pay, ans in zip(payloads, answers):
        h, m = tci.encode_video_frames(clip_model,
                                       videos[pay["reference_video"]], 64)
        h, m = tci.build_combiner_inputs(h, m, dim=RN.embed_dim)
        text = tci.encode_text(clip_model, tok, pay["text"], 12)
        order = tci.rank_index(combiner, h, m, text, index_high)
        assert ans["results"] == [names[i] for i in order[:4]]
    assert handler.batcher.rows_run == len(payloads)


@pytest.mark.parametrize("flag", ["caption_checkpoint", "explain_checkpoint",
                                  "demo"])
def test_serve_flags_of_unported_routes_still_raise(flag):
    """Every route of the JAX server is ported: the caption and explain
    flags build their routes from the checkpoint (a missing one raises
    FileNotFoundError), and `demo` alone registers no route (the pages
    are served by create_server)."""
    args = argparse.Namespace(**{flag: "x" if flag != "demo" else True})
    if flag == "demo":
        assert tserve.build_service(args).handlers == {}
        return
    with pytest.raises(FileNotFoundError):
        tserve.build_service(args)


def test_composed_serving_bench_runs_on_the_cpu(tmp_path, capsys):
    comb = tcomb.CombinerConfig(clip_feature_dim=24, projection_dim=16,
                                hidden_dim=20, middle_mix="conv4x4")
    rows = bserve.run_composed(videos=6, device="cpu", root=str(tmp_path),
                               clip_cfg=RN, comb_cfg=comb, n_single=3,
                               clients=3, per_client=1, wave_calls=2,
                               n_refs=2, ref_shape=(4, 36, 48))
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    metrics = [r["metric"] for r in rows]
    assert metrics == ["serve_composed_batch1", "serve_composed_conc3",
                       "serve_composed_wave1", "serve_composed_wave8",
                       "serve_composed_extract"]
    assert [r["metric"] for r in printed] == metrics
    for r in rows:
        assert r["unit"].endswith("/cpu") and r["device"] == "cpu"
        assert np.isfinite(r["value"])
    assert rows[1]["n"] == 3 and rows[3]["wave_rows"] == 8
    assert rows[2]["events_ms"] is None
