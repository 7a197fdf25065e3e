"""GPT-2 350M, 4-stage pipeline with 2 virtual stages per rank: the port of
``configs/gpt2_350m_pp.py`` (its values; 24 layers as 4 ranks x 2 chunks of
3 layers, GPipe's interleaved schedule over 8 microbatches)."""

from tpu_parallel_torch.configs.common import model_overrides


def get_config():
    return dict(
        simulate_cpu_devices=0,
        model="gpt2_350m",
        # interleave=2: 24 layers as 4 ranks x 2 virtual stages of 3 layers —
        # bubble (4-1)/(8*2+3) = 16% vs GPipe's (4-1)/(8+3) = 27%
        model_overrides=model_overrides(
            num_microbatches=8, pipe_interleave=2,
            attn_impl="flash", remat_policy="proj_attn",
        ),
        mesh=dict(data=-1, model=1, pipe=4, seq=1),
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
        eos_id=50256,
        eval_steps=0,
        eval_every=0,  # >0: periodic eval during fit (uses the held-out split)
        keep_best=False,  # snapshot lowest-eval-loss state to {checkpoint_dir}/best
    )
