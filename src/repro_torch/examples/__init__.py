"""Torch twins of the JAX package's four examples (``examples/*.py``):
the same arguments, defaults, sizes, seeds, schedule arithmetic and
printed lines, plus ``--device`` (default: the card; without one they
raise, ``--device cpu`` runs on the CPU). Each runs as a module:

  PYTHONPATH=src python -m repro_torch.examples.train_resnet_imagenet
  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.serve_decode
  PYTHONPATH=src python -m repro_torch.examples.large_batch_ablation

Each factors its set-up into a ``setup`` function (config, model,
schedule, ``OptConfig``, step, batch functions) that ``main`` drives.
"""
