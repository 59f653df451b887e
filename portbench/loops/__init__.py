"""One module per kind of traffic, named by a cell's ``loop`` key: it
sets the program up, drives the measured window and checks the outputs."""
