"""Per-epoch metric logger with the EMA pseudo-Dice and a progress plot — a
copy of fast_nnunet_tpu/training/logger.py (the reference's
nnunet_logger.py). ``plot_progress_png`` needs matplotlib; the trainer
skips the plot when it is missing."""


class NNUNetLogger:
    def __init__(self):
        self.logging = {
            "mean_fg_dice": [],
            "ema_fg_dice": [],
            "dice_per_class_or_region": [],
            "train_losses": [],
            "val_losses": [],
            "lrs": [],
            "epoch_start_timestamps": [],
            "epoch_end_timestamps": [],
        }

    def log(self, key: str, value, epoch: int) -> None:
        assert key in self.logging, f"unknown log key {key}"
        lst = self.logging[key]
        if len(lst) < epoch + 1:
            lst.extend([None] * (epoch + 1 - len(lst)))
        lst[epoch] = value
        if key == "mean_fg_dice":
            prev = self.logging["ema_fg_dice"][epoch - 1] if epoch > 0 else value
            self.log("ema_fg_dice", prev * 0.9 + 0.1 * value, epoch)

    def plot_progress_png(self, output_folder: str) -> None:
        import matplotlib
        matplotlib.use("agg")
        import matplotlib.pyplot as plt
        epoch = min(len(self.logging["train_losses"]),
                    len(self.logging["val_losses"])) - 1
        if epoch < 0:
            return
        xs = list(range(epoch + 1))
        fig, axes = plt.subplots(3, 1, figsize=(10, 12), sharex=True)
        axes[0].plot(xs, self.logging["train_losses"][:epoch + 1], label="train loss")
        axes[0].plot(xs, self.logging["val_losses"][:epoch + 1], label="val loss")
        axes[0].legend(); axes[0].set_ylabel("loss")
        axes[1].plot(xs, self.logging["mean_fg_dice"][:epoch + 1], label="pseudo dice")
        axes[1].plot(xs, self.logging["ema_fg_dice"][:epoch + 1],
                     label="pseudo dice (EMA)")
        axes[1].legend(); axes[1].set_ylabel("dice")
        if len(self.logging["epoch_end_timestamps"]) > epoch and \
                len(self.logging["epoch_start_timestamps"]) > epoch:
            times = [e - s for s, e in zip(
                self.logging["epoch_start_timestamps"][:epoch + 1],
                self.logging["epoch_end_timestamps"][:epoch + 1])]
            axes[2].plot(xs, times, label="epoch time (s)")
        axes[2].legend(); axes[2].set_xlabel("epoch")
        fig.tight_layout()
        fig.savefig(f"{output_folder}/progress.png")
        plt.close(fig)

    def get_checkpoint(self) -> dict:
        return self.logging

    def load_checkpoint(self, checkpoint: dict) -> None:
        self.logging = checkpoint
