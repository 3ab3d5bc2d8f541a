"""The port's multi-process command line and multi-device extraction.

  (e) `python -m vlsa_tpu_torch.main --handler SA` as two processes joined
      through a `distributed` dict (mesh {data: 2}, gloo on the CPU): both
      ranks print the same final metrics (atol 1e-9), equal to the
      single-process run's at rtol 1e-4 / atol 1e-5 (the tolerance of
      tests/test_multihost.py), and only rank 0 writes the run's files; a
      `mesh` with no `distributed` ({data: 1, model: 2}: ABMIL sequence
      parallel) starts its own ranks, which print those metrics too.  Each
      process with its own save path, of which only rank 0's holds
      checkpoints, both ranks evaluate rank 0's best checkpoint and resume
      at rank 0's last one, as one process does.
  (f) `FeatureExtractor(num_devices=N)` at N = 2 and 4 (on the CPU, N
      replicas run one after another, as vlsa_tpu's virtual CPU devices)
      against vlsa_tpu's `FeatureExtractor(num_devices=4)` on the 8 virtual
      devices tests/conftest.py sets up (tests/test_extract.py:416) and the
      port's own num_devices=1; the CLI's --num_devices.

vlsa_tpu is imported in the test bodies only.
"""
import csv
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import yaml

from vlsa_tpu_torch.main import read_metrics
from vlsa_tpu_torch.parallel.multihost import coordinator_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PATIENTS = 24
SA_RUN = {
    "task": "sa", "seed": 42, "save_prediction": True, "eval_training_loader_per_epoch": False,
    "ckpt_for_eval": "last", "num_shot": -1, "dataset_name": "tcga_mh",
    "path_patch": "synthetic://N=96,D=32,seed=5", "path_coord": None, "data_mode": "patch",
    "path_cluster": None, "path_graph": None, "feat_format": "pt", "time_format": "interval",
    "time_bins": None, "data_split_seed": 0, "arch": "DeepMIL", "init_wt": False,
    "net_output_converter": "softmax", "net_dims": "32-16-4", "deepmil_network": "ABMIL",
    "deepmil_pooling": "attention", "deepmil_use_feat_proj": False, "deepmil_drop_rate": 0.0,
    "loss_type": "SurvIFMLE", "loss_survifmle_weight": 1.0, "evaluator": "NLL-IF",
    "opt_name": "adam", "opt_lr": 0.001, "opt_weight_decay": 0.00001, "epochs": 1,
    "batch_size": 1, "bp_every_batch": 8, "num_workers": 0, "min_bucket": 256,
    "fixed_bucket": 256, "es": False, "monitor_metrics": "loss", "lrs": False, "test": False,
    "prefetch": 0}


# the tiny flagship of tests/test_multihost.py (TP over a width-32 tower's
# MLP, VLFAN's co-attention sequence parallel)
VLSA_RUN = dict(
    SA_RUN, task="vlsa", arch="VLSA", vlsa_api="CONCH", path_patch="synthetic://N=96,D=64,seed=5",
    path_clip_model=None, model_saver_module_filter="prompt_encoder",
    vlsa_frozen_logit_scale=False, vlsa_img_encoder_name="VLFAN", vlsa_img_encoder_frozen=False,
    vlsa_img_encoder_dim_in=64, vlsa_img_encoder_dim_hid=32,
    vlsa_img_encoder_use_feat_proj=False, vlsa_img_encoder_drop_rate=0.0,
    vlsa_img_encoder_pred_head="default", vlsa_img_encoder_query="Text",
    vlsa_img_encoder_num_query=None, vlsa_img_encoder_query_pooling="mean",
    vlsa_img_encoder_gated_query=False, vlsa_img_encoder_query_text_method="TaskRes",
    vlsa_img_encoder_query_text_res_ratio=0.5,
    vlsa_img_encoder_query_text_load_path="vlsa_tpu/assets/tools/survival_text_prototypes.json",
    vlsa_img_encoder_query_text_load_idx="tcga_blca_0",
    vlsa_txt_encoder_name="mahmoodlab/conch", vlsa_txt_encoder_frozen=True,
    vlsa_pmt_learner_name="CoOp", vlsa_pmt_learner_pretrained=False,
    vlsa_pmt_learner_coop_ckpt=None, vlsa_pmt_learner_coop_method="rank",
    vlsa_pmt_learner_coop_num_ranks=None, vlsa_pmt_learner_coop_num_base_ranks=4,
    vlsa_pmt_learner_coop_num_tokens_per_rank=4, vlsa_pmt_learner_coop_num_context_tokens=8,
    vlsa_pmt_learner_coop_rank_tokens_position="tail",
    vlsa_pmt_learner_coop_init_prompt_path="vlsa_tpu/assets/tools/survival_prompts.json",
    vlsa_pmt_learner_coop_init_prompt_rank_idx=0,
    vlsa_pmt_learner_coop_init_prompt_context_idx=0,
    vlsa_pmt_learner_coop_rank_specific_context=False,
    vlsa_pmt_learner_coop_frozen_context_embeds=False,
    vlsa_pmt_learner_coop_frozen_rank_embeds=False, loss_type="SurvIFMLE-QueryDiv",
    loss_querydiv_weight=0.1, evaluator="VL-IF",
    _test_tower_overrides={"width": 32, "heads": 4, "layers": 2, "output_dim": 64})
CLF_RUN = dict(
    SA_RUN, task="clf", seed=1, net_dims="32-16-2", loss_type="CE", loss_ce_smoothing=0.1,
    evaluator="Binary", net_output_converter="softmax")
for key in ("time_format", "time_bins", "loss_survifmle_weight"):
    del CLF_RUN[key]


def write_cohort(root: str):
    """survival.csv (one slide a patient) and splits_0.csv (train 14, val
    5, test 5)."""
    rng = np.random.default_rng(35)
    pids = [f"P{i:03d}" for i in range(N_PATIENTS)]
    table = os.path.join(root, "survival.csv")
    with open(table, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["pathology_id", "patient_id", "e", "t"])
        for pid in pids:
            w.writerow([pid + "-slide", pid, int(rng.random() < 0.7),
                        round(float(rng.uniform(2, 90)), 2)])
    cols = [pids[:14], pids[14:19], pids[19:]]
    with open(os.path.join(root, "splits_0.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "train", "val", "test"])
        for i in range(14):
            w.writerow([i] + [c[i] if i < len(c) else "" for c in cols])
    with open(os.path.join(root, "labels.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "pathology_id", "label"])
        for i, pid in enumerate(pids):
            w.writerow([pid, pid + "-slide", i % 2])
    return table, os.path.join(root, "splits_{2}.csv")


def _cfg(tmp_path, table, split, name, base=SA_RUN, **changes):
    cfg = dict(base, path_table=table, data_split_path=split, save_path=str(tmp_path / name))
    cfg.update(changes)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


# at most this many processes at once: a grid that starts its own ranks
# counts its launcher and each rank, and a `distributed` pair goes in one wave
WAVE_PROCESSES = 6
WAVE_TIMEOUT = 300  # seconds a wave may take before its processes are killed
# coordinator ports held from `_pair` until every run has ended (coordinator_port)
HELD_PORTS = []


def _processes(cfg: dict) -> int:
    mesh = cfg.get("mesh") or {}
    if cfg.get("distributed") or not mesh:
        return 1
    return 1 + mesh.get("data", 1) * mesh.get("model", 1)


def _waves(runs: dict) -> list:
    """The runs in order, in waves of at most WAVE_PROCESSES processes; the
    two processes of a `distributed` pair in the same wave."""
    units, pairs = [], {}
    for name, (_path, cfg) in runs.items():
        spec = cfg.get("distributed")
        if spec:
            key = spec["coordinator_address"]
            if key not in pairs:
                pairs[key] = []
                units.append(pairs[key])
            pairs[key].append(name)
        else:
            units.append([name])
    waves, size = [[]], 0
    for unit in units:
        n = sum(_processes(runs[k][1]) for k in unit)
        if waves[-1] and size + n > WAVE_PROCESSES:
            waves.append([])
            size = 0
        waves[-1].extend(unit)
        size += n
    return waves


def _kill(procs: dict) -> None:
    for p in procs.values():
        if p.poll() is None:
            p.kill()
    for p in procs.values():
        p.wait()


def _launch(runs: dict, handler: dict) -> dict:
    """Every run's `python -m vlsa_tpu_torch.main`, in waves (`_waves`):
    {name: output}.  Each must exit 0 within its wave's WAVE_TIMEOUT; the
    wave's processes are polled, and at the first that fails, or at the
    timeout, every process still running is killed and each failing run is
    reported with its return code and last lines."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = {}
    try:
        for wave in _waves(runs):
            logs = {k: tempfile.TemporaryFile("w+") for k in wave}
            procs = {}
            try:
                for k in wave:
                    procs[k] = subprocess.Popen(
                        [sys.executable, "-m", "vlsa_tpu_torch.main", "--config", runs[k][0],
                         "--handler", handler.get(k, "SA"), "--device", "cpu"], cwd=REPO,
                        env=env, stdout=logs[k], stderr=subprocess.STDOUT, text=True)
                deadline = time.monotonic() + WAVE_TIMEOUT
                while time.monotonic() < deadline:
                    codes = [p.poll() for p in procs.values()]
                    if None not in codes or any(c not in (None, 0) for c in codes):
                        break
                    time.sleep(0.2)
                failed = [k for k, p in procs.items() if p.poll() not in (None, 0)]
                late = [k for k, p in procs.items() if p.poll() is None]
            finally:
                _kill(procs)
                for k, f in logs.items():
                    f.seek(0)
                    outs[k] = f.read()
                    f.close()
            if failed:
                pytest.fail(f"runs {failed} failed ({late} were still running and were "
                            "killed):\n" + _report(procs, outs, failed))
            if late:
                pytest.fail(f"runs {late} took more than {WAVE_TIMEOUT} s and were killed:\n"
                            + _report(procs, outs, late))
    finally:
        while HELD_PORTS:
            HELD_PORTS.pop().close()
    return outs


def _report(procs: dict, outs: dict, names: list) -> str:
    return "\n".join(f"--- {k}: return code {procs[k].returncode}\n{outs.get(k, '')[-3000:]}"
                     for k in names)


def _pair(tmp_path, table, split, name, save_paths=None, **changes):
    """Two `distributed` processes on mesh {data: 2} (each its own save path
    unless `save_paths` names them).  The coordinator's port stays held
    until the runs have ended, so that no other pair is given it."""
    port, sock = coordinator_port()
    HELD_PORTS.append(sock)
    return {f"{name}{i}": _cfg(tmp_path, table, split, f"{name}{i}", mesh={"data": 2},
                               distributed={"coordinator_address": f"127.0.0.1:{port}",
                                            "num_processes": 2, "process_id": i},
                               **dict(changes, **({"save_path": save_paths[i]}
                                                  if save_paths else {})))
            for i in (0, 1)}


# early stopping keeps the best of 4 epochs, which lr 0.05 makes the third
BEST = dict(es=True, ckpt_for_eval="best", epochs=4, opt_lr=0.05)
# a run that resumes at epoch 1 of 2 from a checkpoint only rank 0's save path holds
RESUME = dict(auto_resume=True, epochs=2)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every command-line run of (e), in waves of at most WAVE_PROCESSES
    processes: the SA as two `distributed` processes and as one; grids that start their own ranks
    (SA, VLSA, CLF); the two processes on rank 0's best checkpoint and on
    rank 0's last one (`auto_resume`), and the same runs as one process."""
    from vlsa_tpu_torch.main import run
    from vlsa_tpu_torch.runner.sa import SAHandler
    tmp_path = tmp_path_factory.mktemp("cli")
    table, split = write_cohort(str(tmp_path))
    runs = _pair(tmp_path, table, split, "rank")
    runs["single"] = _cfg(tmp_path, table, split, "single")
    runs["spawned"] = _cfg(tmp_path, table, split, "spawned", mesh={"data": 1, "model": 2})
    # the other handlers on a grid that starts its own ranks
    runs["vlsa"] = _cfg(tmp_path, table, split, "vlsa", base=VLSA_RUN,
                        mesh={"data": 1, "model": 2})
    runs["clf"] = _cfg(tmp_path, str(tmp_path / "labels.csv"), split, "clf", base=CLF_RUN,
                       mesh={"data": 2})
    runs.update(_pair(tmp_path, table, split, "best", **BEST))
    runs["best_single"] = _cfg(tmp_path, table, split, "best_single", **BEST)
    # epoch 1 of the resumed runs, here; rank 1's save path and the pair's own stay empty
    _path, first = _cfg(tmp_path, table, split, "resume_first", **dict(RESUME, epochs=1))
    with redirect_stdout(io.StringIO()):
        run(SAHandler, first, "cpu")
    shutil.copytree(first["save_path"], str(tmp_path / "resume_single"))
    runs.update(_pair(tmp_path, table, split, "resume",
                      save_paths=[first["save_path"], str(tmp_path / "resume1")], **RESUME))
    runs["resume_single"] = _cfg(tmp_path, table, split, "resume_single", **RESUME)
    outs = _launch(runs, {"vlsa": "VLSA", "clf": "CLF"})
    return runs, outs, {k: read_metrics(out) for k, out in outs.items()}


def assert_metrics_match(got: dict, want: dict, rtol=1e-4, atol=1e-5):
    assert got.keys() == want.keys()
    for split in want:
        assert got[split].keys() == want[split].keys()
        for name, value in want[split].items():
            assert np.isclose(got[split][name], value, rtol=rtol, atol=atol), \
                (split, name, got[split][name], value)


def test_cli_runs_across_processes(cli_runs):
    runs, outs, got = cli_runs
    assert [len(got[k]) for k in ("rank0", "rank1", "single", "spawned", "vlsa", "clf")] \
        == [1, 1, 1, 2, 2, 2]
    assert "[setup] mesh: data=2 model=1 (tensor_parallel=False, seq_parallel=False)" \
        in outs["rank0"]
    assert "[setup] mesh: data=1 model=2 (tensor_parallel=True, seq_parallel=True)" \
        in outs["spawned"]
    single = got["single"][0]
    assert_metrics_match(got["rank1"][0], got["rank0"][0], rtol=0, atol=1e-9)
    for run in (got["rank1"][0], got["spawned"][0], got["spawned"][1]):
        assert_metrics_match(run, single)
    assert 0.0 <= single["test"]["pred_c_index"] <= 1.0
    for k, main in (("vlsa", "pred_c_index"), ("clf", "pred_auc")):
        assert got[k][0] == got[k][1] and 0.0 <= got[k][0]["test"][main] <= 1.0, got[k]
    assert "[setup] mesh: data=2 model=1 (tensor_parallel=False, seq_parallel=False)" \
        in outs["clf"]
    # only global rank 0 writes the run's files
    assert os.path.exists(os.path.join(runs["rank0"][1]["save_path"], "train_model-last.ckpt"))
    assert not os.path.exists(runs["rank1"][1]["save_path"])
    assert os.path.exists(os.path.join(runs["spawned"][1]["save_path"], "metrics.jsonl"))


@pytest.mark.parametrize("name", ["best", "resume"])
def test_ranks_take_rank0s_checkpoint(cli_runs, name):
    """Two `distributed` processes, each with its own save path, of which
    only rank 0's holds checkpoints: with early stopping both evaluate rank
    0's best checkpoint (an epoch before the last), and with `auto_resume`
    both resume at the epoch of rank 0's last one.  Both print the same
    metrics (atol 1e-9), those of the same run as one process (rtol 1e-4 /
    atol 1e-5)."""
    import torch
    runs, outs, got = cli_runs
    assert [len(got[k]) for k in (f"{name}0", f"{name}1", f"{name}_single")] == [1, 1, 1]
    assert_metrics_match(got[f"{name}1"][0], got[f"{name}0"][0], rtol=0, atol=1e-9)
    assert_metrics_match(got[f"{name}0"][0], got[f"{name}_single"][0])
    saved = os.path.join(runs[f"{name}0"][1]["save_path"], "train_model-best.ckpt")
    if name == "best":
        assert "[bestckpt/train/test/pred]" in outs["best0"]
        best = torch.load(saved, weights_only=False)["epoch"]
        assert best < BEST["epochs"], "the best epoch is the last: the test would see no fault"
    else:
        assert not os.path.exists(runs["resume1"][1]["save_path"])
        for k in ("resume0", "resume1", "resume_single"):
            assert "[train] auto-resume: continuing from epoch 1" in outs[k], outs[k][-3000:]
            assert "[train] epoch 2/2" in outs[k] and "[train] epoch 1/2" not in outs[k]


SMALL = dict(layers=2, width=64, heads=4, embed_dim_contrast=64, embed_dim_caption=32,
             attn_pooler_heads=4, n_queries_caption=4, patch_size=16)


EXTRACT_KW = dict(model_name="conch", image_size=32, batch_size=4, compute_dtype="float32",
                  model_overrides=SMALL)


def extraction_tiles():
    """10 tiles at the model's size and 10 raw 48x40 ones (resized)."""
    rng = np.random.default_rng(21)
    return (rng.integers(0, 255, (10, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 255, (10, 48, 40, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def jax_extraction():
    """vlsa_tpu's FeatureExtractor(num_devices=4): its weights as the
    port's state dict, and its features of the tiles at the model's size."""
    import jax
    from vlsa_tpu.data.extract import FeatureExtractor as JaxExtractor
    from vlsa_tpu_torch.utils.weights import state_dict_from_jax
    jex = JaxExtractor(num_devices=4, **EXTRACT_KW)
    return (state_dict_from_jax(jax.tree.map(np.asarray, jex._params)),
            jex.extract(extraction_tiles()[0]))


@pytest.mark.parametrize("num_devices", [2, 4])
def test_extraction_splits_each_batch_over_devices(jax_extraction, num_devices):
    """Batch 4, 10 tiles (the last batch ragged): the split batches give
    vlsa_tpu's num_devices=4 features and the port's own num_devices=1 ones
    within 1e-5 (f32; vlsa_tpu's own limit between its one and four
    devices: a part of a batch is a matmul of other shape); raw 48x40 tiles
    too, with host and with device preprocessing."""
    from vlsa_tpu_torch.data.extract import FeatureExtractor
    state, want = jax_extraction
    kw = EXTRACT_KW
    one = FeatureExtractor(device="cpu", **kw)
    many = FeatureExtractor(device="cpu", num_devices=num_devices, **kw)
    assert len(many.replicas) == num_devices and many.devices == [many.device] * num_devices
    for ex in (one, many):
        ex.model.load_state_dict(state, strict=True)
    tiles, raw = extraction_tiles()
    got = many.extract(tiles)
    assert got.shape == want.shape == (10, SMALL["embed_dim_contrast"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, one.extract(tiles), atol=1e-5, rtol=1e-5)
    many_dev = FeatureExtractor(device="cpu", num_devices=num_devices, device_preprocess=True,
                                **kw)
    many_dev.model.load_state_dict(state, strict=True)
    base = one.extract(raw)
    for ex in (many, many_dev):
        np.testing.assert_allclose(ex.extract(raw), base, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible by num_devices"):
        FeatureExtractor(device="cpu", num_devices=3, **kw)


def test_extraction_cli_takes_num_devices(tmp_path):
    from vlsa_tpu_torch.runner import extract as extract_cli
    buf = io.StringIO()
    with redirect_stdout(buf):
        stats = extract_cli.main(["--synthetic", "1", "--synthetic_tiles", "5", "--image_size",
                                  "32", "--batch", "4", "--num_devices", "2", "--dtype",
                                  "float32", "--out", str(tmp_path), "--device", "cpu"])
    assert json.loads(buf.getvalue().splitlines()[-1]) == stats
    assert stats["slides"] == 1 and stats["tiles"] == 5
    feats = np.load(tmp_path / "synthetic_0.npy")
    assert feats.shape == (5, 512) and np.isfinite(feats).all()
