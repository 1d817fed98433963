"""Rank processes for the port's data-parallel tests (`test_torch_ddp.py`,
`test_torch_global_negatives.py`, `test_torch_tails.py`).

`run_ranks(fn, world, *args)` starts `world` processes, each a rank of a
`gloo` process group on the CPU, calls `fn(dp, *args)` with its
`parallel.DataParallel` and returns the ranks' results in rank order
(`Ranks` starts them and joins later, so that the caller works
meanwhile). This module imports torch and the port only, so that a rank
starts without JAX; its functions are the ranks' bodies."""

from __future__ import annotations

import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

# The tests' tiny configuration: 24 frames of width 16, 3 predictions, 4
# negatives, linear prediction heads (no dropout anywhere).
WINDOW, WIDTH, K, N = 3840, 16, 3, 4
S = WINDOW // 160
W = S - K


def port_flags(**extra) -> list:
    flags = {"--pathDB": ".", "--file_extension": ".wav", "--device": "cpu",
             "--sizeWindow": WINDOW, "--hiddenEncoder": WIDTH,
             "--hiddenGar": WIDTH, "--nPredicts": K,
             "--negativeSamplingExt": N, "--rnnMode": "linear",
             "--random_seed": 0}
    flags.update(extra)
    argv = []
    for name, value in flags.items():
        argv += [name] if value is True else [name, str(value)]
    return argv


def _entry(rank, fn, world, port, tmp, dcn, deadline):
    torch.set_num_threads(1)
    from cpc2_torch.parallel import DataParallel, init_process_group
    # the rank bodies' own lazy imports (Adam's first construction among
    # them) while the caller prepares their inputs
    import cpc2_torch.feature_loader  # noqa: F401
    import cpc2_torch.training  # noqa: F401
    torch.optim.Adam([torch.zeros(1, requires_grad=True)])
    device = torch.device("cpu")
    init_process_group(rank, world, device, f"tcp://127.0.0.1:{port}",
                       timeout_s=120)
    try:
        dp = DataParallel(rank, world, device, dcn)
        try:
            path = os.path.join(tmp, "args.pt")
            while not os.path.exists(path):
                if time.time() > deadline:
                    raise TimeoutError("the ranks' arguments never came")
                time.sleep(0.02)
            out = fn(dp, *torch.load(path, weights_only=False))
        except Exception:           # the test reads it
            out = {"error": traceback.format_exc()}
        torch.save(out, os.path.join(tmp, f"{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


class Ranks:
    """`world` rank processes started on `fn(dp, *args)`: they start at
    once, and run `fn` when `send(*args)` gives its arguments (at the
    start if `args` are given), so that the caller prepares them
    meanwhile; the arguments go through a file, since a process's start
    waits for its child to read what it is sent through a pipe. `join()`
    waits for them (at most `timeout_s` from the start) and returns their
    results in rank order, raising a rank's error; `kill()` ends them."""

    def __init__(self, fn, world: int, *args, dcn: int = 0,
                 timeout_s: float = 300):
        from cpc2_torch.parallel import free_port
        self.world = world
        self._tmp = tempfile.TemporaryDirectory()
        self._deadline = time.monotonic() + timeout_s
        self._timeout_s = timeout_s
        self._ranks = mp.start_processes(
            _entry, args=(fn, world, free_port(), self._tmp.name, dcn,
                          time.time() + timeout_s),
            nprocs=world, join=False, start_method="spawn")
        if args:
            self.send(*args)

    def send(self, *args) -> None:
        part = os.path.join(self._tmp.name, "args.part")
        torch.save(args, part)
        os.replace(part, os.path.join(self._tmp.name, "args.pt"))

    def kill(self) -> None:
        """End the ranks (the caller failed before `join`)."""
        for p in self._ranks.processes:
            p.kill()
        self._tmp.cleanup()

    def join(self) -> list:
        try:
            while not self._ranks.join(timeout=1):
                if time.monotonic() > self._deadline:
                    for p in self._ranks.processes:
                        p.kill()
                    raise AssertionError(f"{self.world} ranks still running "
                                         f"after {self._timeout_s} s")
            out = [torch.load(os.path.join(self._tmp.name, f"{r}.pt"),
                              weights_only=False)
                   for r in range(self.world)]
        finally:
            self._tmp.cleanup()
        for r, res in enumerate(out):
            if isinstance(res, dict) and "error" in res:
                raise AssertionError(f"rank {r}:\n{res['error']}")
        return out


def run_ranks(fn, world: int, *args, dcn: int = 0,
              timeout_s: float = 300) -> list:
    return Ranks(fn, world, *args, dcn=dcn, timeout_s=timeout_s).join()


def build(argv, model_sd=None, crit_sd=None):
    """The port's model and criterion from a command line, with the given
    state dicts (numpy or tensors) loaded."""
    from cpc2_torch.config import parse_args
    from cpc2_torch.feature_loader import build_model
    from cpc2_torch.losses import CPCUnsupervisedCriterion
    args = parse_args(argv)
    model = build_model(args)
    crit = CPCUnsupervisedCriterion(
        args.nPredicts, args.hiddenGar, args.hiddenEncoder,
        args.negativeSamplingExt, size_input_seq=args.sizeWindow // 160,
        rnn_mode=args.rnnMode, neg_pool_group=args.neg_pool_group)
    for module, sd in ((model, model_sd), (crit, crit_sd)):
        if sd is not None:
            module.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                    for k, v in sd.items()})
    return args, model, crit


def state(model, crit) -> dict:
    """Every parameter and buffer, by `model.`/`criterion.` name, as
    numpy."""
    out = {}
    for prefix, module in (("model", model), ("criterion", crit)):
        for k, v in module.state_dict().items():
            out[f"{prefix}.{k}"] = v.detach().cpu().numpy().copy()
    return out


def grads(model, crit) -> dict:
    return {f"{prefix}.{k}": p.grad.detach().numpy().copy()
            for prefix, module in (("model", model), ("criterion", crit))
            for k, p in module.named_parameters()}


def trainer_of(dp, argv, model_sd=None, crit_sd=None, seed=0,
               augment=False):
    """A `Trainer` of the port as rank `dp` (None: one process), Adam as
    the flags say, the weights given or from `seed` and then rank 0's, its
    generator seeded as the trainer seeds a rank's; with `augment` the
    device chain's `bandreject` on both views, drawn from a generator of
    the rank's own (as `train.py` seeds it)."""
    from cpc2_torch.data.augment_device import make_device_augment
    from cpc2_torch.parallel import rank_seed
    from cpc2_torch.training import Trainer, make_optimizer
    torch.manual_seed(seed)
    args, model, crit = build(argv, model_sd, crit_sd)
    if dp is not None:
        dp.replicate(model, crit)
    rank = 0 if dp is None else dp.rank
    gen, augment_gen = torch.Generator(), torch.Generator()
    gen.manual_seed(rank_seed(seed, rank))
    augment_gen.manual_seed(rank_seed(seed + 5, rank))
    params = list(model.parameters()) + list(crit.parameters())
    chain = ((make_device_augment(["bandreject"]), True, True, False)
             if augment else None)
    trainer = Trainer(model, crit, make_optimizer(args, params), gen,
                      device_augment=chain, augment_generator=augment_gen,
                      dp=dp, global_negatives=args.global_negatives)
    return trainer


def steps(dp, argv, model_sd, crit_sd, batches, negs=None, weights=None):
    """Training steps of a rank's trainer: batch i is global (the rank
    takes its rows); `negs[i]` the rank's negatives (a list by rank, or
    one array for every rank) or None for its own draws, `weights[i]` the
    global weights or None. Returns each step's (losses, accs), the state
    after, the last step's gradients (reduced over the ranks) and the
    generator's state."""
    trainer = trainer_of(dp, argv, model_sd, crit_sd)
    out = []
    for i, batch in enumerate(batches):
        rank, world = (0, 1) if dp is None else (dp.rank, dp.world)
        x = np.asarray(batch)
        x = x[rank * len(x) // world:(rank + 1) * len(x) // world]
        neg = None if negs is None or negs[i] is None else negs[i]
        if isinstance(neg, list):
            neg = neg[rank]
        kw = {}
        if weights is not None and weights[i] is not None:
            wts = np.asarray(weights[i], np.float32)
            if world > 1:
                wts = wts[rank * len(wts) // world:
                          (rank + 1) * len(wts) // world]
            kw["example_weights"] = torch.from_numpy(wts)
        losses, accs = trainer.train_step(
            torch.from_numpy(x),
            None if neg is None else torch.from_numpy(neg), **kw)
        out.append((losses.numpy().copy(), accs.numpy().copy()))
    if dp is not None:
        dp.check_replicas(trainer.model, trainer.criterion)
    return {"steps": out, "state": state(trainer.model, trainer.criterion),
            "grads": grads(trainer.model, trainer.criterion),
            "generator": trainer.generator.get_state()}


def cases(dp, entries):
    """Several `steps` runs in one start of the ranks: entries of (fn
    name, args), each result in order."""
    return [globals()[name](dp, *args) for name, args in entries]


def layouts(dp, dcns, *args):
    """`steps(*args)` once for each node count of `dcns`, in the same
    process group."""
    from cpc2_torch.parallel import DataParallel
    out = []
    for dcn in dcns:
        layout = DataParallel(dp.rank, dp.world, dp.device, dcn)
        out.append(dict(steps(layout, *args),
                        layout=layout.layout.tolist()))
    return out


def check_lengths(dp, lengths):
    """The lock-step guard on this rank's `lengths[rank]`: its message, or
    None if it passed."""
    try:
        dp.check_lengths(lengths[dp.rank], "loader lengths")
    except RuntimeError as e:
        return str(e)
    return None


def gather(dp, rows, d, seed):
    """`gather_pool` of this rank's (rows, d) block and the gradient of
    sum(pool * cot) with cot the same on every rank: the pool and this
    rank's gradient."""
    from cpc2_torch.parallel import gather_pool
    rs = np.random.RandomState(seed + dp.rank)
    z = torch.from_numpy(rs.randn(rows, d)).requires_grad_(True)
    cot = torch.from_numpy(np.random.RandomState(seed).randn(
        dp.world * rows, d))
    pool = gather_pool(z, dp)
    (pool * cot).sum().backward()
    return pool.detach().numpy(), z.grad.numpy()


def pod_tails(dp, argv):
    """`PodTailRunner` with rank r holding 2 - r short batches of one row:
    its rounds, each round's real rows, and the state after."""
    from cpc2_torch.train_tails import PodTailRunner
    trainer = trainer_of(dp, argv)
    tails = PodTailRunner(dp, 2, S, WINDOW, False)
    rs = np.random.RandomState(10 + dp.rank)
    for _ in range(2 - dp.rank):
        tails.add((rs.randn(1, 2, 1, WINDOW).astype(np.float32),
                   np.zeros(1, np.int64), None, None))
    out = tails.run_train(trainer, False)
    return {"rounds": [(n, l.numpy(), a.numpy()) for n, l, a in out],
            "state": state(trainer.model, trainer.criterion)}


def one_host_tail(dp, argv, batch):
    """A short batch of 3 rows on 2 ranks through `TailRunner`, then a
    reduced step on the first 2 rows of a full batch, the views augmented
    on the device (each rank's own augmentation generator for its rows),
    and the replicas compared (`check_replicas`)."""
    from cpc2_torch.train_tails import TailRunner, route
    trainer = trainer_of(dp, argv, augment=True)
    tails = TailRunner(torch.device("cpu"), 11)
    assert route(3, 4, dp) == "alone"
    losses, accs = tails.train(trainer, torch.from_numpy(batch[:3]))
    after_tail = state(trainer.model, trainer.criterion)
    trainer.train_step(torch.from_numpy(dp.rows(batch[:4])))
    dp.check_replicas(trainer.model, trainer.criterion)
    return {"tail": (losses.numpy(), accs.numpy()), "after_tail":
            after_tail, "generator": tails.generator.get_state(),
            "augment_generator": tails.augment_generator.get_state(),
            "state": state(trainer.model, trainer.criterion)}


def drifted_replicas(dp):
    """`check_replicas` on a model that rank 1 has changed in one weight:
    its message on each rank, or None if it passed."""
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    if dp.rank == 1:
        with torch.no_grad():
            model.weight[0, 0] += 1e-6
    try:
        dp.check_replicas(model)
    except RuntimeError as e:
        return str(e)
    return None
