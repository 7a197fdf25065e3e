"""GPT-2 125M, 1-D Megatron tensor parallelism: the port of
``configs/gpt2_125m_tp.py`` (its values; every rank of the group on the
model axis)."""

from tpu_parallel_torch.configs.common import model_overrides


def get_config():
    return dict(
        simulate_cpu_devices=0,
        model="gpt2_125m",
        # flash attention, attention residuals saved by the proj_attn remat
        # policy, layers unrolled
        model_overrides=model_overrides(
            attn_impl="flash", remat_policy="proj_attn", scan_layers=False
        ),
        mesh=dict(data=1, model=-1, pipe=1, seq=1),
        global_batch_size=32,
        num_minibatches=1,
        steps=100,
        optimizer="adamw",  # adamw | lion | sgd
        lr_schedule="cosine",  # cosine | linear | constant
        ema_decay=0.0,  # >0 keeps an EMA shadow of params (eval prefers it)
        learning_rate=6e-4,
        warmup_steps=20,
        weight_decay=0.1,
        grad_clip=1.0,
        seed=0,
        log_every=10,
        donate=True,
        # optional run plumbing (empty = disabled)
        checkpoint_dir="",
        checkpoint_every=100,
        data_path="",
        data_format="flat",  # flat | packed (EOS-delimited docs + segment_ids)
        eos_id=50256,
        eval_steps=0,
        eval_every=0,  # >0: periodic eval during fit (uses the held-out split)
        keep_best=False,  # snapshot lowest-eval-loss state to {checkpoint_dir}/best
    )
