"""Plain NumPy references, one module per query, found by the query's name
(``flockbench/reference/<query>.py``).  Each is written from the query's SQL
and imports nothing of the program.  A module defines

* ``reference(tables, config)``: the window's result columns from the
  window's host tables, as exact integers (or an f64 divided once
  from exact integers, as q4's average);
* ``least_bytes(tables, config, out)``: the least bytes the window's
  operators need on the device (each input column the query reads, read
  once; each aggregate's slot table and each output written once), from
  the window's shapes, whatever implements them;
* optionally ``control(tables, config)``: the control of the comparison
  (``flockbench/control.py``) where replaying the window's events leaves
  the query's answer as it was.
"""
