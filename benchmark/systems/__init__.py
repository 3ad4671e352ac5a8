"""The system under test, one module a model kind (a configuration's
``model``): how a cell builds the program's model and calls its train
step or its apply, through the port's public names, and which reference
loss matches it."""
