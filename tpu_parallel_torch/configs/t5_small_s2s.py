"""T5-small encoder-decoder through the Trainer CLI: the port of
``configs/t5_small_s2s.py`` (its values).  The registry's ``t5_small``
gives a ``Seq2SeqConfig``, so the Trainer builds the ``EncoderDecoder``,
the teacher-forced loss and synthetic copy-task batches; the encoder runs
the flash kernels non-causally over its padding segments, the decoder
causally, with the attention residuals saved by remat."""

from tpu_parallel_torch.configs.common import model_overrides


def get_config():
    return dict(
        simulate_cpu_devices=0,
        model="t5_small",
        model_overrides=model_overrides(attn_impl="flash", remat_policy="proj_attn",
                                        scan_layers=False, enc_layers=None, src_seq_len=None),
        mesh=dict(data=-1, model=1, pipe=1, seq=1),
        global_batch_size=16,
        num_minibatches=1,
        steps=50,
        optimizer="adamw",
        objective="seq2seq",
        mlm_mask_rate=0.15,
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
        eos_id=0,
        eval_steps=0,
        eval_every=0,
        keep_best=False,
    )
