"""Llama-style 1B on a DP x TP x PP 3-D mesh: the port of
``configs/llama_1b_3d.py`` (its values; FSDP over the data axis splits each
tensor-parallel slice again, ``parallel/fsdp.py``)."""

from tpu_parallel_torch.configs.common import model_overrides


def get_config():
    return dict(
        simulate_cpu_devices=0,
        model="llama_1b",
        model_overrides=model_overrides(
            num_microbatches=8, fsdp=True,
            attn_impl="flash", remat_policy="proj_attn",
        ),
        mesh=dict(data=-1, model=4, pipe=4, seq=1),
        global_batch_size=64,
        num_minibatches=1,
        steps=100,
        optimizer="adamw",  # adamw | lion | sgd
        lr_schedule="cosine",  # cosine | linear | constant
        ema_decay=0.0,  # >0 keeps an EMA shadow of params (eval prefers it)
        learning_rate=3e-4,
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
        # GPT-2's EOS, beyond this vocabulary of 32000: the flat format never reads it
        eos_id=50256,
        eval_steps=0,
        eval_every=0,  # >0: periodic eval during fit (uses the held-out split)
        keep_best=False,  # snapshot lowest-eval-loss state to {checkpoint_dir}/best
    )
