"""Training: AdamW, the train step, checkpoints and fault tolerance.

  optimizer.py   — ``OptConfig``, AdamW on tensors, the LR schedule
  compression.py — int8 error-feedback gradient compression
  train_step.py  — ``TrainState``, ``StepConfig``, ``make_train_step``
  checkpoint.py  — the reference's on-disk layout, both ways
  fault.py       — watchdog, checkpoint cadence, ``SimulatedFailure``

Each mirrors its namesake in ``repro.train``.
"""
