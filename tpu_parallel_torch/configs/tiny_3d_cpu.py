"""Tiny GPT on a 2x2x2 DP x TP x PP mesh of 8 gloo CPU processes: the port
of ``configs/tiny_3d_cpu.py`` (its values)."""

from tpu_parallel_torch.configs.common import model_overrides


def get_config():
    return dict(
        simulate_cpu_devices=8,
        model="tiny",
        model_overrides=model_overrides(num_microbatches=2),
        mesh=dict(data=2, model=2, pipe=2, seq=1),
        global_batch_size=16,
        num_minibatches=1,
        steps=20,
        optimizer="adamw",  # adamw | lion | sgd
        lr_schedule="cosine",  # cosine | linear | constant
        ema_decay=0.0,  # >0 keeps an EMA shadow of params (eval prefers it)
        learning_rate=3e-3,
        warmup_steps=5,
        weight_decay=0.1,
        grad_clip=1.0,
        seed=0,
        log_every=5,
        donate=True,
        # optional run plumbing (empty = disabled)
        checkpoint_dir="",
        checkpoint_every=10,
        data_path="",
        data_format="flat",  # flat | packed (EOS-delimited docs + segment_ids)
        eos_id=50256,
        eval_steps=0,
        eval_every=0,  # >0: periodic eval during fit (uses the held-out split)
        keep_best=False,  # snapshot lowest-eval-loss state to {checkpoint_dir}/best
    )
