"""How a traffic mix drives the program, one module an ``entry`` name of
the traffic files: ``warm_up``, ``window`` and ``reference_answers``."""
