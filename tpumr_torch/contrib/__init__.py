"""Optional components on the public interfaces of the engine.

Counterpart of ``tpumr/contrib/``, where only ``datajoin`` is ported; the
fair and capacity schedulers are not.
"""
