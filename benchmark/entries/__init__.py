"""How a traffic mix drives the program, one module an ``entry`` name of
the traffic files: ``warm_up``, ``window`` and ``replay``. Each draws its
queries from the traffic's generator (``ctx.gen``) and serves them as
``make_query`` builds them. ``window`` returns, beside its metrics, the
queries it sent (``specs``), their ``answers`` and its ``calls``: the
``(first, end)`` range of ``specs`` each call into the program served;
``replay`` serves one such call again as the window served it."""


def make_query(it, spec, top: int):
    """The program's ``Query`` of a ``generators.Spec``: its text, ``top``
    records, and each option set as an attribute (a ``filter`` given as
    Infiscript text parsed by ``Filter.parse``)."""
    q = it.Query(spec.text, top)
    for name, value in spec.options:
        if not hasattr(q, name):
            raise ValueError(f"a query option {name!r}: Query has no such "
                             "attribute")
        if name == "filter" and isinstance(value, str):
            value = it.Filter.parse(value)
        setattr(q, name, value)
    return q
