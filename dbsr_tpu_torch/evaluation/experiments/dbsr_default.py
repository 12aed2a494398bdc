"""Default eval spec: the latest checkpoint of the workspace's
``dbsr/default_synthetic`` run."""

from dbsr_tpu_torch.evaluation.network_param import NetworkParam


def main():
    return [
        NetworkParam(module="dbsr", parameter="default_synthetic",
                     net_name="dbsr_synthetic"),
    ]
