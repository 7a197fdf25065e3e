"""Reference-parity config: tiny model, DP over 8 simulated CPU devices.
The port of ``configs/mlp_dp_cpu.py`` (its values): the CLI runs it in 8
gloo CPU processes (``runtime.spawn_cpu_ranks``).  Despite its name it
trains the tiny GPT; the MLP classifier serves the DP tests."""

def get_config():
    return dict(
        simulate_cpu_devices=8,
        model="tiny",
        # the JAX config declares no model overrides
        model_overrides={},
        mesh=dict(data=8, model=1, pipe=1, seq=1),
        global_batch_size=32,
        num_minibatches=4,
        steps=15,
        optimizer="adamw",  # adamw | lion | sgd
        lr_schedule="cosine",  # cosine | linear | constant
        ema_decay=0.0,  # >0 keeps an EMA shadow of params (eval prefers it)
        learning_rate=1e-3,
        warmup_steps=5,
        weight_decay=0.01,
        grad_clip=1.0,
        seed=69,
        log_every=5,
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
