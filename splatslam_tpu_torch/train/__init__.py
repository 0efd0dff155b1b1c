from .droid_trainer import (train, train_dba, make_train_step,  # noqa: F401
                            make_dba_train_step, make_optimizer,
                            load_selftrained)
