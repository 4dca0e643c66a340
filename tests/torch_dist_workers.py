"""The process side of the multi-process CPU tests of the port (``tests/test_torch_dp.py``,
``tests/test_torch_parallel.py``, ``tests/test_torch_dp_multistep.py``): ``run_group``
spawns a gloo group whose processes import torch and the port alone (never jax), and
``train_steps`` (single steps) or ``multi_steps`` (grouped calls) is what each process of
a group runs. Not a test module: pytest collects nothing here."""
from __future__ import annotations

import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch

GROUP_TIMEOUT_S = 60.0  # a collective that waits longer fails its process


def run_group(fn, nprocs: int, tmp_path: Path, spec: dict, timeout: float = 120.0):
    """Run ``fn(spec)`` in `nprocs` spawned processes that join one gloo group through a
    file under `tmp_path` (no port to collide with another test's), joined with a
    deadline: a process still alive after `timeout` s is killed and the call fails, as
    does any process that raised (its traceback in the message). Returns each process's
    result, by rank."""
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, rank, nprocs, str(tmp_path), spec))
             for rank in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [(tmp_path / f"rank{r}.err").read_text() for r in range(nprocs)
              if (tmp_path / f"rank{r}.err").exists()]
    assert not hung and not errors, (hung, errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(nprocs)]


def _entry(fn, rank: int, nprocs: int, out: str, spec: dict):
    from segan_pytorch_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    try:
        mesh.initialize_distributed(f"file://{out}/rendezvous", nprocs, rank, "cpu",
                                    timeout_s=GROUP_TIMEOUT_S)
        torch.save(fn(spec), f"{out}/rank{rank}.pt")
        mesh.shutdown_distributed()
    except BaseException:
        Path(f"{out}/rank{rank}.err").write_text(traceback.format_exc())
        raise


def randomize_port(module: torch.nn.Module, seed: int):
    """Weights at O(1) scale in the port's names (``randomize`` of
    ``test_torch_discriminator.py`` in torch): weights 1/sqrt(fan_in), PReLU slopes
    U(0, 0.3), BN scales and running variances U(0.5, 1.5), biases and means
    N(0, 0.1^2). Spectral u and v stay as drawn."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("weight_u", "weight_v", "num_batches_tracked"):
                continue
            if leaf == "running_var" or ".norm." in name and leaf == "weight":
                t.copy_(torch.empty(t.shape).uniform_(0.5, 1.5, generator=g))
            elif t.dim() >= 2:
                fan = t[0].numel() if t.dim() > 1 else 1
                t.copy_(torch.randn(t.shape, generator=g) / np.sqrt(fan))
            elif leaf == "weight":  # PReLU slopes
                t.copy_(torch.empty(t.shape).uniform_(0.0, 0.3, generator=g))
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)


def build_engine(spec: dict):
    """The engine of `spec`: 'engine' ('segan', 'wsegan' or 'aewsegan'), 'cfg'
    (SEGANConfig fields), 'state' ((G, D) state dicts; AEWSEGAN's D None) and 'float64'
    (the models in float64 and the engine's compute dtype float64); its grid is placed
    (``init_train``)."""
    from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
    from segan_pytorch_tpu_torch.models.generator import build_generator
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.models.wsegan import AEWSEGAN, WSEGAN
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    cfg = SEGANConfig(**spec["cfg"])
    kind = spec.get("engine", "segan")
    G = build_generator(cfg)
    D = build_discriminator(cfg) if kind != "aewsegan" else None
    if spec.get("state") is not None:
        G.load_state_dict(spec["state"][0], strict=True)
        if D is not None:
            D.load_state_dict(spec["state"][1], strict=True)
    if spec.get("float64"):
        G = G.double()
        D = D.double() if D is not None else None
    if kind == "aewsegan":
        seg = AEWSEGAN(cfg, generator=G, device="cpu")
    else:
        cls = WSEGAN if kind == "wsegan" else SEGAN
        seg = cls(cfg, generator=G, discriminator=D, device="cpu")
    if spec.get("float64"):
        seg.compute_dtype = torch.float64
    seg.init_train()
    return seg


def run_steps(seg, spec: dict) -> dict:
    """`spec`'s steps on `seg`: 'batches' are global (clean, noisy, mask[, amask]) numpy
    arrays, of which this process takes its rows; 'draws' (optional) the global draws of
    each step. Returns the metrics and Genh rows of each step."""
    out = {"metrics": [], "genh": []}
    for i, batch in enumerate(spec["batches"]):
        B = batch[0].shape[0] // seg._dp()
        rows = seg.grid.rows(B) if seg.grid is not None else slice(None)
        local = [torch.from_numpy(np.ascontiguousarray(a[rows])) for a in batch]
        draws = spec["draws"][i] if spec.get("draws") else {}
        metrics, genh, _ = seg.train_step(*local, spec.get("l1", 100.0), **draws)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["genh"].append(genh.numpy())
    return out


def run_multi(seg, spec: dict) -> dict:
    """`spec`'s grouped calls on `seg` (``train_step_multi``): each of 'calls' holds
    'stacked', the global (S, B, ...) arrays of ``batch_keys``, of which this process
    takes its rows, 'l1', the S L1 weights, and optionally 'draws', the global stacked
    draws by name. Returns each call's metrics (a list of S floats by name) and its last
    sub-step's Genh rows."""
    out = {"metrics": [], "genh": []}
    for call in spec["calls"]:
        B = call["stacked"][0].shape[1] // seg._dp()
        rows = seg.grid.rows(B) if seg.grid is not None else slice(None)
        local = [torch.from_numpy(np.ascontiguousarray(a[:, rows])) for a in call["stacked"]]
        draws = {k: torch.as_tensor(v) for k, v in call.get("draws", {}).items()}
        metrics_s, _, genh, _ = seg.train_step_multi(*local, l1_w_s=call["l1"], **draws)
        out["metrics"].append({k: v.tolist() for k, v in metrics_s.items()})
        out["genh"].append(genh.numpy())
    return out


def multi_steps(spec: dict) -> dict:
    """One process of a test group running grouped calls: the engine of `spec`
    (``build_engine``), its calls (``run_multi``), the whole state after them and the
    steps taken."""
    seg = build_engine(spec)
    out = {"grid": (seg.grid.dp_index, seg.grid.mp_index) if seg.grid else None}
    out.update(run_multi(seg, spec))
    out.update(whole_state(seg))
    out["step"] = seg.step
    return out


def whole_state(seg) -> dict:
    """G's and D's state dicts and D's optimizer state, D's head put together (D's
    empty without a D)."""
    def copy(sd):
        return {k: v.clone() for k, v in sd.items()}

    with seg._whole_head():
        if seg.D is None:
            return {"G": copy(seg.G.state_dict()), "D": {}, "d_opt": {}}
        return {"G": copy(seg.G.state_dict()), "D": copy(seg.D.state_dict()),
                "d_opt": {name: copy(seg.d_opt.state[p])
                          for name, p in seg.D.named_parameters()
                          if p in seg.d_opt.state}}


def train_steps(spec: dict) -> dict:
    """One process of a test group: the engine of `spec` (``build_engine``), then, each
    when `spec` asks: 'resume' from a run directory (this process's part of D's fc.0
    after it is returned), 'evaluate' a validation set before the steps ('eval_dirs',
    'eval_cache'), the steps (``run_steps``), 'save' into a run directory. Returns what
    it saw, with the whole state after the steps."""
    from segan_pytorch_tpu_torch.utils.checkpoint import Saver

    seg = build_engine(spec)
    out = {"grid": (seg.grid.dp_index, seg.grid.mp_index) if seg.grid else None}
    if spec.get("resume"):
        out["resumed_step"] = seg.resume(spec["resume"])
        out["fc0_part"] = seg.D.fc[0].weight.detach().clone()
    if spec.get("eval_dirs"):
        from segan_pytorch_tpu_torch.data.loader import DataLoader
        from segan_pytorch_tpu_torch.data.se_dataset import SEDataset

        ds = SEDataset(*spec["eval_dirs"], 0.95, cache_dir=spec["eval_cache"],
                       slice_size=seg.cfg.slice_size, slice_workers=1)
        va = DataLoader(ds, batch_size=300, shuffle=False, num_workers=1, seed=5)
        out["evaluate"] = seg.evaluate(seg.cfg, va, 100, do_noisy=True)
        seg.close_pool()
    out.update(run_steps(seg, spec))
    out.update(whole_state(seg))
    if spec.get("save"):
        seg.save(Saver(spec["save"], prefix="EOE_G-"), Saver(spec["save"], prefix="EOE_D-"),
                 len(spec["batches"]))
    if spec.get("checksum"):
        out["checksum"] = checksums(seg)
    return out


def checksums(seg) -> list:
    """The resume check's verdicts: on the group's weights as they are, then with one
    weight of rank 1's G moved (each None, or the message it raised)."""
    verdicts = []
    for moved in (False, True):
        if moved and torch.distributed.get_rank() == 1:
            with torch.no_grad():
                next(seg.G.parameters()).add_(1.0)
        try:
            seg._verify_resume_consistency()
            verdicts.append(None)
        except RuntimeError as e:
            verdicts.append(str(e))
    return verdicts


def graph_on_gloo(spec: dict) -> dict:
    """A grouped call of two sub-steps by an engine of a gloo group that stands on a
    CUDA device (its device set by hand: here there is no card): the step's graph
    cannot hold gloo's collectives, so the call must raise before it moves anything.
    Returns the message and whether the engine's streams and step count stayed."""
    seg = build_engine(spec)
    seg.device = torch.device("cuda")
    phase_state = seg._phase_train.get_state()
    B = spec["cfg"]["batch_size"] // seg._dp()
    stacked = [torch.zeros((2, B, spec["cfg"]["slice_size"], 1))] * 2 + [torch.ones((2, B))]
    try:
        seg.train_step_multi(*stacked, l1_w_s=[100.0, 100.0])
        message = None
    except RuntimeError as e:
        message = str(e)
    return {"message": message, "untouched": seg.step == 0 and seg._multi is None
            and torch.equal(seg._phase_train.get_state(), phase_state)}


def fail_on_rank_1(spec: dict) -> dict:
    """Rank 1 raises before a collective that rank 0 then waits in."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails before the collective")
    torch.distributed.all_reduce(torch.ones(1))
    return {}
