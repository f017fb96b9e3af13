"""One driver a kind of configuration: it builds the program and the
cell's inputs from the seed and a traffic file's parameters, steps the
program in a closed loop, and checks what it produced against the plain
reference."""
