"""GPT-2 125M at 8k context: the port of ``configs/gpt2_125m_long.py``.

Sequences of 8192 run the flash kernels at their long shape, and
``loss_chunk`` keeps the [batch, seq, vocab] logits from ever existing in
full (at 8192 x 50304 they would be 0.8 GB bf16 per row).  16 rows in 8
accumulation minibatches of 2.
"""

from tpu_parallel_torch.configs.common import model_overrides


def get_config():
    return dict(
        model="gpt2_125m",
        model_overrides=model_overrides(
            seq_len=8192,
            attn_impl="flash",
            remat_policy="proj_attn",
            loss_chunk=1024,
            scan_layers=False,
        ),
        mesh=dict(data=-1, model=1, pipe=1, seq=1),
        global_batch_size=16,
        num_minibatches=8,
        steps=50,
        optimizer="adamw",
        lr_schedule="cosine",
        ema_decay=0.0,
        learning_rate=3e-4,
        warmup_steps=10,
        weight_decay=0.1,
        grad_clip=1.0,
        seed=0,
        log_every=10,
        donate=True,
        checkpoint_dir="",
        checkpoint_every=100,
        data_path="",
        data_format="flat",
        eos_id=50256,
        eval_steps=0,
        eval_every=0,
        keep_best=False,
    )
