"""The harness of the benchmark: discovery by name, the guard on imports,
the device checks, the traced window and the result line.  Nothing here
imports the program under test; the drivers and the models do."""
