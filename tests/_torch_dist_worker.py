"""Rank worker for the port's distributed twin tests (gloo on the CPU).

:func:`run_ranks` starts ``world`` processes of this script, which meet
through a ``file://`` store, run the decoders of a pickled job with
``torch.distributed`` and pickle each case's result per rank.  The script
imports only the port (the suite's ``conftest.py``, which imports jax,
never loads here).

A job is ``{"world": n, "cases": {name: case}}``, each case a dict with
``mesh`` (shape, axis names) and either ``decoder`` (a class name of
``kaldi_decoder_tpu_torch.parallel`` or ``kaldi_decoder_tpu_torch.decoders``),
``args`` and ``kw`` of the constructor, and ``scores`` and ``lengths`` to
decode; or ``call`` (a function of ``parallel.graph_shard`` taking the
mesh's ``model`` group as ``group``), ``rank_args`` (its arguments on each
rank) and ``kw``.  A decoder case may name ``capture``: functions of
``parallel.graph_shard`` whose calls' positional arguments the rank keeps
during the decode (tensors cloned, in tuples and named tuples too;
numbers, strings and None kept; anything else as None); its result is
then (the decode result, {name: [arguments of each call]}).  A decoder
case with ``decodes`` instead of ``scores`` and ``lengths`` runs each
(scores, lengths, mode) on the one decoder, in order: mode "driver" as a
user calls it, "loop" within ``decoders.driver.eager_frames()``, "held"
within ``parallel.shard_driver.held_counts`` and then counted as 2
replays of what it held (``add_replays``); its result is a list of
{"result", "launches" (each of ``shard_driver.COUNTED``'s counts and the
first-frame mode's and K8's local half's, their growth over the call),
"calls" (the growth of ``mesh.collective_calls`` by kind), "replays"
(of ``decoders.driver.replays``), "held" (mode "held": (launches, calls)
held)}.

    python tests/_torch_dist_worker.py JOB RANK
"""

import contextlib
import os
import pickle
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run_ranks(job: dict, tmp_dir: str, timeout: float = 600) -> list:
    """Run ``job`` on ``job["world"]`` ranks; returns each rank's results
    ({case name: decode result}), in rank order.  Fails with the ranks'
    output if one exits non-zero."""
    path = os.path.join(tmp_dir, "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(r)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(job["world"])
    ]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited with {p.returncode}:\n{log}")
    out = []
    for r in range(job["world"]):
        with open(f"{path}.rank{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


def kept(x):
    """A captured argument: ``x`` with its tensors cloned (in tuples and
    named tuples too), numbers, strings and None as they are, anything
    else None."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        items = [kept(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x if x is None or isinstance(x, (bool, int, float, str)) else None


def decode_counted(dec, scores, lengths, mode):
    """One decode of a ``decodes`` case (see the module docstring)."""
    from collections import Counter

    from kaldi_decoder_tpu_torch.decoders import driver
    from kaldi_decoder_tpu_torch.kernels.cutoff import global_cutoff_local
    from kaldi_decoder_tpu_torch.kernels.frame import frame_start
    from kaldi_decoder_tpu_torch.parallel import shard_driver
    from kaldi_decoder_tpu_torch.parallel.mesh import collective_calls

    counted = shard_driver.COUNTED + (frame_start, global_cutoff_local)
    n0, c0, r0 = [f.launches for f in counted], Counter(collective_calls), driver.replays
    out = {"held": None}
    if mode == "held":
        box = {}
        held = shard_driver.held_counts(lambda: box.update(result=dec.decode(scores, lengths)))
        shard_driver.add_replays(*held, 2)
        out.update(result=box["result"], held=(held[0], dict(held[1])))
    else:
        with driver.eager_frames() if mode == "loop" else contextlib.nullcontext():
            out["result"] = dec.decode(scores, lengths)
    out.update(launches=[f.launches - n for f, n in zip(counted, n0)],
               calls=dict(collective_calls - c0), replays=driver.replays - r0)
    return out


def main():
    path, rank = sys.argv[1], int(sys.argv[2])
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    import kaldi_decoder_tpu_torch.decoders as decoders
    import kaldi_decoder_tpu_torch.parallel as parallel
    from kaldi_decoder_tpu_torch.parallel import graph_shard

    torch.set_num_threads(1)
    with open(path, "rb") as f:
        job = pickle.load(f)
    parallel.initialize_distributed(
        device_type="cpu", init_method=f"file://{path}.store", rank=rank,
        world_size=job["world"],
    )
    results = {}
    for name, case in job["cases"].items():
        mesh = parallel.make_mesh(*case["mesh"], device_type="cpu")
        if "call" in case:
            fn = getattr(graph_shard, case["call"])
            results[name] = fn(*case["rank_args"][rank], group=mesh.get_group("model"),
                               **case["kw"])
            continue
        cls = getattr(parallel, case["decoder"], None) or getattr(decoders, case["decoder"])
        dec = cls(*case["args"], mesh=mesh, device="cpu", **case["kw"])
        if "decodes" in case:
            results[name] = [decode_counted(dec, *d) for d in case["decodes"]]
            continue
        captured = {fn: [] for fn in case.get("capture", ())}
        orig = {fn: getattr(graph_shard, fn) for fn in captured}

        def keep(fn):
            def call(*args, **kw):
                captured[fn].append(tuple(kept(x) for x in args))
                return orig[fn](*args, **kw)

            return call

        for fn in captured:
            setattr(graph_shard, fn, keep(fn))
        try:
            res = dec.decode(case["scores"], case["lengths"])
        finally:
            for fn, f in orig.items():
                setattr(graph_shard, fn, f)
        results[name] = (res, captured) if captured else res
    with open(f"{path}.rank{rank}", "wb") as f:
        pickle.dump(results, f)
    parallel.shutdown_distributed()


if __name__ == "__main__":
    main()
