"""Plain NumPy references, one module per query, found by the query's name
(``flockbench/reference/<query>.py``).  Each is written from the query's SQL
and imports nothing of the program.  A module defines

* ``reference(tables, config)``: the window's result columns from the
  window's host tables, as exact integers;
* ``least_bytes(tables, config, out)``: the least bytes the window's
  operators need on the device (each input column the query reads, read
  once; each aggregate's slot table and each output written once), from
  the window's shapes, whatever implements them.
"""
