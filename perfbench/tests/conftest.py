"""What the tables of the harness's tests lack for drivers and cells added after them.

``faults.FAULTS`` names the faults each driver's cells can have, and
``test_perfbench_control.py``'s ``CONTROL`` the lower-precision control of
each cell; both predate ``drivers/biggan_fit.py`` (``gan_fit``'s corpus,
feed and window with labels, so ``gan_fit``'s faults) and its cell (the fp8
control of the bf16 nets). They are added here before the tests collect.
"""

from perfbench import faults

faults.FAULTS.setdefault("biggan_fit", faults.FAULTS["gan_fit"])
CONTROL = {"rnagan-biggan256.cond-cli-train-b8": "fp8"}


def pytest_collection_modifyitems(items):
    for item in items:
        table = getattr(item.module, "CONTROL", None)
        if isinstance(table, dict):
            for cell, control in CONTROL.items():
                table.setdefault(cell, control)
