"""Scripts over the port's CLIs: the algorithm zoo (``train_zoo``) and the
summary of its learning curves (``learning_report``)."""
