"""The yardstick's cost model: the work an algorithm needs, counted from the
shapes, and the card's data-sheet peaks. One function or table a file, each
a frozen copy of the program's own count at the time the benchmark was
defined (its docstring names the line), so a later change to the program
is read against the same work."""
