"""The example entry points, as modules of the port.

Each module ports one script of the reference's ``examples/`` under the
same name and runs as ``python -m repro_torch.examples.<name>``:

  quickstart            one round of the paper's pipeline end to end
  tradeoff_playground   Algorithm 1 over a power, model-size or lambda sweep
  train_federated       the §V experiment (``federated.system.run``)
  fleet_sim             the fleet engine's command line (``fleet.run_fleet``)
  pruned_llm_federated  a transformer trained by the fleet
  serve_pruned          train, export and serve a block-pruned model

Every module has ``main(argv=None)``: the reference script's flags (same
names, defaults and help) and ``--device``, where ``None`` means the card
(``device.resolve_device``; ``--device cpu`` runs the plain versions on
the CPU).  It prints the lines the reference prints and returns them as
a dict.  Importing a module runs nothing.  Where the reference draws
with ``jax.random``, the port draws from a ``torch.Generator`` seeded as
the reference seeds its key; the draws themselves differ.
"""
