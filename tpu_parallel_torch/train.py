"""Training entry point of the port: the counterpart of the repo's
``train.py``.

    python -m tpu_parallel_torch.train --config=gpt2_125m_corpus \\
        --config.data_path=corpus.bin --config.checkpoint_dir=/tmp/ckpt \\
        --config.steps=1000 --config.model_overrides.loss_chunk=1024

``--config`` names a config of ``tpu_parallel_torch/configs`` (or a path
whose file name is one); ``--config.<key>=<value>`` overrides a declared
key, typed from its default.  ``--trace-out PATH`` writes a Chrome
trace-event JSON of per-step ``data_wait``/``compute`` spans (Perfetto);
``--metrics-out PATH`` a Prometheus text snapshot of the trainer's registry.
``--device`` defaults to ``cuda`` and raises without a GPU.

Data and tensor parallelism run under torchrun, one process per card:

    python -m torch.distributed.run --standalone --nproc_per_node=8 \
        -m tpu_parallel_torch.train --config=gpt2_125m_dp
    python -m torch.distributed.run --standalone --nproc_per_node=2 \
        -m tpu_parallel_torch.train --config=gpt2_125m_tp
    python -m torch.distributed.run --standalone --nproc_per_node=4 \
        -m tpu_parallel_torch.train --config=gpt2_125m_long \
        --config.mesh.data=1 --config.mesh.seq=4 \
        --config.model_overrides.attn_impl=ring

The script calls ``runtime.initialize()`` first (a no-op outside torchrun)
and logs ``process_info()``; the config's mesh then spans the group.  A
config with ``simulate_cpu_devices`` > 0 (``mlp_dp_cpu``) runs in that many
gloo CPU processes started by ``runtime.spawn_cpu_ranks``, the
counterpart of JAX's simulated CPU devices.  Rank 0 prints the logs.

The flow is the JAX script's: flat or packed data (``data_format``) with a
held-out split, ``Trainer.fit`` when ``checkpoint_dir`` is set (resume,
periodic saves, rollback, evaluation) and ``Trainer.train`` over the
prefetching loader otherwise, then the final evaluation.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv):
    """``(config dict, options)`` from the command line."""
    from tpu_parallel_torch.configs import get_config, override

    parser = argparse.ArgumentParser(prog="python -m tpu_parallel_torch.train")
    parser.add_argument("--config", required=True,
                        help="config name or path (tpu_parallel_torch/configs)")
    parser.add_argument("--trace-out", "--trace_out", dest="trace_out", default="",
                        help="write a Chrome trace-event JSON of per-step spans here")
    parser.add_argument("--metrics-out", "--metrics_out", dest="metrics_out", default="",
                        help="write a Prometheus text snapshot of the registry here")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--backend", default=None,
                        help="process group backend (default: nccl for a card, gloo for "
                             "the CPU); gloo with --device=cuda:0 puts every rank on one card")
    args, rest = parser.parse_known_args(argv)
    config = get_config(args.config)
    for arg in rest:
        if not arg.startswith("--config.") or "=" not in arg:
            parser.error(f"unrecognized argument {arg!r} (overrides are --config.<key>=<value>)")
        key, value = arg[len("--config."):].split("=", 1)
        override(config, key, value)
    return config, args


def main(argv=None) -> int:
    config_dict, args = parse_args(sys.argv[1:] if argv is None else argv)
    sim = config_dict.pop("simulate_cpu_devices", 0)
    if sim:
        from tpu_parallel_torch.runtime import spawn_cpu_ranks

        args.device = "cpu"
        spawn_cpu_ranks(sim, run, config_dict, args)
        return 0
    from tpu_parallel_torch.runtime import initialize

    # the process group first: the trainer's mesh and device come from it
    initialize(device=args.device, backend=args.backend)
    try:
        return run(config_dict, args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run(config_dict, args) -> int:
    """Train ``config_dict`` in this process (a rank of the group when one
    is up); every rank trains, rank 0 prints."""
    import json

    from tpu_parallel_torch.runtime import process_info
    from tpu_parallel_torch.train_lib import Trainer, TrainerConfig

    topology = process_info()
    lead = topology["process_index"] == 0

    def say(text):
        if lead:
            print(text, flush=True)

    say(f"topology: {json.dumps(topology)}")
    cd = dict(config_dict)
    checkpoint_dir = cd.pop("checkpoint_dir", "")
    checkpoint_every = cd.pop("checkpoint_every", 100)
    data_path = cd.pop("data_path", "")
    # "flat": contiguous seq_len windows; "packed": EOS-delimited documents
    # packed whole into rows with segment_ids (in-kernel attention masking)
    data_format = cd.pop("data_format", "flat")
    eos_id = cd.pop("eos_id", 50256)  # GPT-2's <|endoftext|>
    eval_steps = cd.pop("eval_steps", 0)
    eval_every = cd.pop("eval_every", 0)
    keep_best = cd.pop("keep_best", False)
    # fraction of the token stream held out for eval (never trained on)
    eval_fraction = cd.pop("eval_fraction", 0.1 if (eval_steps or eval_every) else 0.0)
    config = TrainerConfig.from_config_dict(cd)
    tracer = None
    if args.trace_out:
        from tpu_parallel_torch.obs import Tracer

        tracer = Tracer()
    trainer = Trainer(config, device=args.device, tracer=tracer)
    say(f"model={config.model} params={trainer.num_params / 1e6:.1f}M "
        f"device={trainer.device}")

    data_loader = None
    if data_path:
        from tpu_parallel_torch.data import DataLoader, PackedDataset, TokenDataset

        paths = data_path.split(",") if "," in data_path else data_path
        if data_format == "packed":
            if isinstance(paths, list):
                raise NotImplementedError(
                    "packed datasets read a single .bin stream "
                    "(concatenate shards at prepare time)"
                )
            dataset = PackedDataset(paths, trainer.model_config.seq_len, eos_id=eos_id)
        elif data_format == "flat":
            dataset = TokenDataset(paths, trainer.model_config.seq_len)
        else:
            raise ValueError(f"data_format={data_format!r} (flat | packed)")
        # ranks that differ only along the model axis step on the same rows;
        # a seq rank takes its block of each row's tokens
        data_loader = DataLoader(dataset, config.global_batch_size, seed=config.seed,
                                 holdout_fraction=eval_fraction, device=trainer.device,
                                 process_count=trainer.data_size,
                                 process_index=trainer.data_index,
                                 seq_count=trainer.seq_size, seq_index=trainer.seq_index)
        if eval_steps:
            # fail fast: an eval split smaller than one batch should abort
            # before training, not after it
            data_loader.eval_view()

    def log_fn(step, metrics):
        parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
        say(f"step {step}: {parts}")

    if (eval_every or keep_best) and not checkpoint_dir:
        raise ValueError(
            "eval_every/keep_best run inside the fault-tolerant fit loop — "
            "set checkpoint_dir too"
        )
    if checkpoint_dir:
        final = trainer.fit(
            checkpoint_dir,
            data_loader=data_loader,
            checkpoint_every=checkpoint_every,
            log_fn=log_fn,
            eval_every=eval_every,
            eval_steps=eval_steps or 10,
            keep_best=keep_best,
        )
    else:
        final = trainer.train(
            batch_iter=data_loader.prefetch() if data_loader else None,
            log_fn=log_fn,
        )
    say(f"final: {final}")
    if eval_steps:
        # held-out split: windows the train loader can never sample
        eval_iter = iter(data_loader.eval_view()) if data_loader else None
        say(f"eval: {trainer.evaluate(batch_iter=eval_iter, steps=eval_steps)}")
    if tracer is not None and lead:
        from tpu_parallel_torch.obs import write_chrome_trace

        say(f"trace: {write_chrome_trace(tracer, args.trace_out)}")
    if args.metrics_out and lead:
        from tpu_parallel_torch.obs import write_prometheus

        say(f"metrics: {write_prometheus(trainer.registry, args.metrics_out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
