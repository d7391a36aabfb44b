"""Training of the port: ``loop.init_train_state`` and
``loop.make_train_step`` (the counterparts of ``repro.train.loop``)."""
