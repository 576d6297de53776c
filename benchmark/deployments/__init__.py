"""Deployments, one module a ``deployment_module`` name of the
configuration files.

A configuration names its deployment (``"deployment_module": "<name>"``,
no default): ``benchmark/deployments/<name>.py``, which answers three
questions.

* Documents: ``documents(config, seed)`` makes, from the seed, what the
  engine indexes and what the reference and the traffic's generator
  read (a namespace; the upstream generator reads ``titles``).
* Engine: ``engine(it, made, config)`` builds the program's engine
  (``it`` is ``infidex_tpu_torch``) with those documents indexed.
* Reference: ``reference(made)`` builds the plain reference from
  ``benchmark/reference/`` (after the window, once the program's state
  is freed), and ``judge(ref, specs, got, replayed, state, top, log)``
  gives the compared numbers of one round of the check
  (``check.replay_rounds``): ``{name: {"value", "limit", "of"}}``. A
  number is a count of sampled queries and its limit is 0; a reference
  may add numbers of its own to the four of ``check.judge``.

A deployment module imports nothing of the program (it is handed
``it``), and its reference half lives under ``benchmark/reference/``,
which imports nothing of the program either.
"""
